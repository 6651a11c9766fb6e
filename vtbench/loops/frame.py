"""``frame``: a closed loop of path frames, ``render.integrator.render_tiled``
at the configuration's ``spp``, with a key a frame folded from the seed's
key.  Traffic parameters: ``call`` (render_tiled's keyword arguments, such
as ``tiles``), ``render`` (RenderConfig fields), ``warmup`` (set-up
frames), ``sample_of_first`` (the check keeps one of the window's first
so many frames, drawn from the seed, and its last)."""

from __future__ import annotations

import torch

from vtbench import compare
from vtbench.loops import Check, Loop, call_args, seed_key


class FrameLoop(Loop):
    def work(self, cfg) -> int:
        """W x H x spp."""
        return cfg.width * cfg.height * cfg.spp

    def setup(self, side, scene, cfg, inputs):
        self.side, self.scene, self.cfg = side, scene, cfg
        self.key = seed_key(side, self.seed)
        self.first = self.t.get("warmup", 2)
        for i in range(self.first):
            self.step(i)

    def frame(self, side, scene, cfg, key, i):
        return side.mod("render.integrator").render_tiled(
            scene, cfg, side.mod("core.rng").fold_in(key, i), cfg.spp,
            **call_args(self.t.get("call")))

    def step(self, i):
        return self.frame(self.side, self.scene, self.cfg, self.key, i)

    def replay(self, i):
        return self.step(i)

    def observe(self, i, out):
        if i == self.first + self.sample:
            self.checks.append(Check(f"frame {i}", {"i": i}, {"image": out}))
        self.last = (i, out)

    def close(self):
        i, out = self.last
        if i != self.first + self.sample:
            self.checks.append(Check(f"frame {i}", {"i": i}, {"image": out}))

    def release(self):
        super().release()
        self.last = None

    def reference(self, side, scene, cfg, inputs, check):
        with torch.no_grad():
            return {"image": self.frame(side, scene, cfg, seed_key(side, self.seed),
                                        check.inputs["i"])}

    def numbers(self, prog, ref) -> dict:
        return {"pixels_off": compare.pixels_off(prog["image"], ref["image"])}


LOOP = FrameLoop
