"""``train_step``: a closed loop of inverse-rendering steps:
``diff.train.fused_step`` (a forward frame and ``binned_grads`` over the
bins ``prepare_bins`` builds once in set-up) and one Adam update of the
density logits and the albedo table, as ``make_train_step`` builds it,
towards a target made from the seed.  Traffic parameters: ``bins``
(``prepare_bins``' keyword arguments), ``call`` (``fused_step``'s),
``lr``, ``checked_steps`` (the set-up's steps, which the check follows),
``render``."""

from __future__ import annotations

import time

import torch

from vtbench import compare
from vtbench.loops import Check, Loop, call_args, seed_key

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8  # optax's defaults
LEAVES = ("density_logits", "albedo_table")


class TrainLoop(Loop):
    counters = Loop.counters + ("lookup_rows_bwd",)

    def units(self) -> str:
        return "steps"

    def work(self, cfg) -> int:
        """W x H: the forward frame's primary rays (1 spp)."""
        return cfg.width * cfg.height

    def make_inputs(self, cfg, device) -> dict:
        gen = torch.Generator(device=device).manual_seed(self.seed % (1 << 63))
        return {"target": torch.rand((cfg.height, cfg.width, 3), generator=gen,
                                     device=device)}

    def _plan(self, side, scene, cfg, target):
        return side.mod("diff.train").prepare_bins(scene, cfg, target,
                                                   **call_args(self.t.get("bins")))

    def _fused(self, side, params, scene, cfg, key, plan):
        return side.mod("diff.train").fused_step(params, scene, cfg, key, plan,
                                                 **call_args(self.t.get("call")))

    def setup(self, side, scene, cfg, inputs):
        """The window's own step object, driven through its first
        ``checked_steps`` steps: the frame mean of each, the first
        gradient as Adam holds it, the parameters' change after them."""
        self.side, self.scene, self.cfg = side, scene, cfg
        self.key = seed_key(side, self.seed)
        self.fold_in = side.mod("core.rng").fold_in
        self.target = inputs["target"]
        self.plan = self._plan(side, scene, cfg, self.target)
        self.params = side.mod("diff.volumetric").params_from_scene(scene)
        step, init = side.mod("diff.train").make_train_step(cfg, lr=self.t["lr"],
                                                            grad_fn=self._grads)
        self._step, self.opt = step, init(self.params)
        leaves = [getattr(self.params, n) for n in LEAVES]
        p0 = [p.detach().clone() for p in leaves]
        means, g1 = [], None
        self.first = self.t["checked_steps"]
        for i in range(self.first):
            means.append(self.step(i))
            if i == 0:
                # Adam's first moment after one step is (1 - b1) x the
                # gradient it got; a step that kept no state got none
                g1 = {n: self.opt.state[p].get("exp_avg", torch.zeros_like(p)).detach()
                      / (1 - ADAM_B1) for n, p in zip(LEAVES, leaves)}
        change = {n: p.detach() - q for n, p, q in zip(LEAVES, leaves, p0)}
        self.checks.append(Check(f"steps 0-{self.first - 1}", {},
                                 {"means": torch.stack(means), "grad": g1, "change": change}))

    def _grads(self, params, scene, target):
        return self._fused(self.side, params, scene, self.cfg, self._key, self.plan)

    def spans(self, out: dict, device):
        """The traced run's spans of each step: ``train.fwd``, the forward
        frame (``render_tiled`` inside ``fused_step``), and ``train.grad``,
        the rest of the step (``binned_grads`` and the Adam update), each
        with a synchronize at its edges -> a function that removes them."""
        mod = self.side.mod("diff.train")
        orig_fwd = mod.render_tiled

        def sync():
            if device.type == "cuda":
                torch.cuda.synchronize(device)

        def fwd(*a, **k):
            sync()
            s = time.perf_counter()
            r = orig_fwd(*a, **k)
            sync()
            self._fwd_end = time.perf_counter()
            out.setdefault("train.fwd", []).append((self._i, self._fwd_end - s))
            return r

        def step(i):
            r = TrainLoop.step(self, i)
            sync()
            out.setdefault("train.grad", []).append((i, time.perf_counter() - self._fwd_end))
            return r

        mod.render_tiled, self.step = fwd, step

        def unhook():
            mod.render_tiled = orig_fwd
            del self.step

        return unhook

    def step(self, i):
        self._i = i
        self._key = self.fold_in(self.key, i)
        self.params, self.opt, mean = self._step(self.params, self.opt, self.scene,
                                                 self.target)
        return mean

    def replay(self, i):
        return self._fused(self.side, self.params, self.scene, self.cfg,
                           self.fold_in(self.key, i), self.plan)

    def release(self):
        super().release()
        self.params = self.opt = self.plan = self._step = self.target = None

    def reference(self, side, scene, cfg, inputs, check):
        """The same steps in plain torch: the reference's fused_step on its
        own bins and parameters, and Adam written out."""
        key, fold_in = seed_key(side, self.seed), side.mod("core.rng").fold_in
        plan = self._plan(side, scene, cfg, inputs["target"].to(scene.device))
        vol = side.mod("diff.volumetric")
        params = vol.params_from_scene(scene)
        leaves = {n: getattr(params, n).detach().clone().requires_grad_() for n in LEAVES}
        p0 = {n: p.detach().clone() for n, p in leaves.items()}
        m = {n: torch.zeros_like(p) for n, p in leaves.items()}
        v = {n: torch.zeros_like(p) for n, p in leaves.items()}
        means, g1 = [], None
        for i in range(self.t["checked_steps"]):
            mean, grads = self._fused(side, vol.DiffParams(**leaves), scene, cfg,
                                      fold_in(key, i), plan)
            means.append(mean.detach())
            g = {n: getattr(grads, n).detach() for n in LEAVES}
            if i == 0:
                g1 = g
            with torch.no_grad():
                for n, p in leaves.items():
                    m[n] = ADAM_B1 * m[n] + (1 - ADAM_B1) * g[n]
                    v[n] = ADAM_B2 * v[n] + (1 - ADAM_B2) * g[n] * g[n]
                    mh = m[n] / (1 - ADAM_B1 ** (i + 1))
                    vh = v[n] / (1 - ADAM_B2 ** (i + 1))
                    p -= self.t["lr"] * mh / (torch.sqrt(vh) + ADAM_EPS)
            for p in leaves.values():
                p.grad = None
        return {"means": torch.stack(means), "grad": g1,
                "change": {n: p.detach() - p0[n] for n, p in leaves.items()}}

    def numbers(self, prog, ref) -> dict:
        mp, mr = prog["means"].double().cpu(), ref["means"].double().cpu()
        moving = compare.moving_leaves(ref["grad"])
        return {"frame_mean_gap": max(compare.rel_gap(float(a), float(b))
                                      for a, b in zip(mp, mr)),
                "grad_norm_gap": compare.norm_gap(prog["grad"], ref["grad"]),
                "change_norm_gap": compare.norm_gap(prog["change"], ref["change"], moving),
                "grad_leaf_gap": compare.norm_gap(prog["grad"], ref["grad"], own=True),
                "change_leaf_gap": compare.norm_gap(prog["change"], ref["change"], own=True)}


LOOP = TrainLoop
