"""``reproject``: a closed loop of static-camera reprojected frames,
``render.reproject.render_reproject_frame``, each frame blending with the
previous frame's history; the set-up's frames fill it from zeros.  One
primary ray a pixel (the entry reads no ``spp``).  Traffic parameters as
``frame``'s: ``call`` (the entry's keyword arguments), ``render``
(``mode`` "reproject"), ``warmup``, ``sample_of_first``.

The check keeps two window frames.  The one drawn from the seed among the
first ``sample_of_first`` is made again by the reference from zeros,
frame by frame on its own history, so its history is judged from start to
finish.  The last is made again from the history the program handed it:
a chain of some hundreds of reference frames would outlast the window."""

from __future__ import annotations

import torch

from vtbench import compare
from vtbench.loops import Check, call_args, seed_key
from vtbench.loops.frame import FrameLoop


class ReprojectLoop(FrameLoop):
    def work(self, cfg) -> int:
        """W x H."""
        return cfg.width * cfg.height

    def setup(self, side, scene, cfg, inputs):
        self.hist = torch.zeros((cfg.height, cfg.width, 3), dtype=torch.float32,
                                device=scene.device)
        self.replays = {}
        super().setup(side, scene, cfg, inputs)

    def frame(self, side, scene, cfg, key, i, hist):
        img, new_hist, _ = side.mod("render.reproject").render_reproject_frame(
            scene, cfg, scene.camera, hist, side.mod("core.rng").fold_in(key, i),
            **call_args(self.t.get("call")))
        return img, new_hist

    def step(self, i):
        self._in = self.hist
        if i in self.replays:
            self.replays[i] = self._in
        img, self.hist = self.frame(self.side, self.scene, self.cfg, self.key, i, self._in)
        return img, self.hist

    def keep_for_replay(self, i):
        self.replays[i] = None

    def replay(self, i):
        return self.frame(self.side, self.scene, self.cfg, self.key, i, self.replays[i])[0]

    def observe(self, i, out):
        if i == self.first + self.sample:  # made again from zeros
            self.checks.append(Check(f"frame {i} from zeros", {"i": i},
                                     {"image": out[0], "history": out[1]}))
        self.last = (i, self._in, out)

    def close(self):
        i, hist, out = self.last
        if i != self.first + self.sample:
            self.checks.append(Check(f"frame {i}", {"i": i, "history": hist},
                                     {"image": out[0], "history": out[1]}))

    def release(self):
        super().release()
        self.hist = self._in = self.replays = None

    def reference(self, side, scene, cfg, inputs, check):
        key, i = seed_key(side, self.seed), check.inputs["i"]
        with torch.no_grad():
            if "history" in check.inputs:
                img, hist = self.frame(side, scene, cfg, key, i,
                                       check.inputs["history"].to(scene.device))
            else:
                hist = torch.zeros((cfg.height, cfg.width, 3), dtype=torch.float32,
                                   device=scene.device)
                for j in range(i + 1):
                    img, hist = self.frame(side, scene, cfg, key, j, hist)
        return {"image": img, "history": hist}

    def numbers(self, prog, ref) -> dict:
        return {"image_pixels_off": compare.pixels_off(prog["image"], ref["image"]),
                "history_pixels_off": compare.pixels_off(prog["history"], ref["history"])}


LOOP = ReprojectLoop
