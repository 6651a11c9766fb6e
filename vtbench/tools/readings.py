#!/usr/bin/env python3
"""The readings that the correctness limits are set from, on the chip at
a cell's own size, in one process:

* the program's numbers on each of ``--seeds`` (its set-up and the first
  window iterations the check keeps, then the reference);
* the control's on each of ``--control-seeds``: the reference in the
  program's place, computed in bfloat16 (``compare.Bf16``);
* for a training cell, each fault of ``--faults`` planted in the program:
  ``half_batch`` (each bin's rays halved, the mean taken over the rest),
  ``density_x0.7`` (the density logits' gradient scaled by 0.7).

Each training reading also gives every leaf's own gaps (``leaves``).

    python3 vtbench/tools/readings.py --workload monu.frame --seeds 1,2,3 \\
        --control-seeds 4,5,6 --out chiprun_out/readings.json
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))


def ints(s):
    return [int(x) for x in s.split(",") if x]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=ints, default=[])
    ap.add_argument("--control-seeds", type=ints, default=[])
    ap.add_argument("--faults", default="")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--width", type=int)
    ap.add_argument("--height", type=int)
    ap.add_argument("--out")
    args = ap.parse_args(argv)

    import torch

    from vtbench import compare, harness, loops, sides, spec

    device = torch.device(args.device)
    cell = spec.cell(args.workload)
    inputs = sides.make_inputs(cell.config)
    ov = loops.render_overrides(cell.traffic)
    if args.width:
        ov.update(width=args.width, height=args.height)
    prog, ref = sides.Side(sides.PROGRAM), sides.Side(sides.REFERENCE)
    out = {"workload": args.workload, "device": torch.cuda.get_device_name(0)
           if device.type == "cuda" else "cpu", "program": {}, "control": {}, "faults": {}}

    def leaves(loop, prog_out, ref_out):
        if "grad" not in prog_out:
            return {}
        return {f"{what}.{k}": v for what in ("grad", "change") for k, v in
                compare.leaf_gaps(prog_out[what], ref_out[what], own=True).items()}

    def run(side, seed, scene, cfg, mode=None):
        loop = loops.make(cell.traffic, seed, sides.has_media(inputs))
        if mode is not None:
            loop.sample = 0  # the control: the window's first frame and its last
        li = loop.make_inputs(cfg, device)
        ctx = mode if mode is not None else contextlib.nullcontext()
        with ctx:
            loop.setup(side, scene, cfg, li)
            for i in range(loop.first, loop.first + loop.sample + 2):
                o = loop.step(i)
                loop.observe(i, o)
            loop.close()
        harness.sync(device)
        t = time.perf_counter()
        nums = harness.reference_numbers(cell, loop, loop.checks, inputs, li, ov, device,
                                         readings=leaves)
        return nums, time.perf_counter() - t

    def show(kind, seed, nums, ref_s):
        out[kind].setdefault(str(seed), nums)
        print(f"{kind} seed {seed}: {nums} (reference {ref_s:.1f} s)", flush=True)

    scene, cfg = sides.make_scene(prog, cell.config, inputs, device, **ov)
    for seed in args.seeds:
        show("program", seed, *run(prog, seed, scene, cfg))
    for fault in filter(None, args.faults.split(",")):
        mod = prog.mod("diff.train")
        orig = mod.binned_grads
        if fault == "half_batch":
            def broken(params, scene_, plan):
                bins = [dataclasses.replace(b, n_active=max(1, b.n_active // 2))
                        for b in plan.bins]
                return orig(params, scene_, dataclasses.replace(plan, bins=bins,
                                                                denom=plan.denom / 2))
        elif fault == "density_x0.7":
            def broken(params, scene_, plan):
                loss, g = orig(params, scene_, plan)
                return loss, dataclasses.replace(g, density_logits=g.density_logits * 0.7)
        else:
            raise SystemExit(f"unknown fault {fault!r}")
        mod.binned_grads = broken
        try:
            for seed in args.control_seeds:
                nums, rs = run(prog, seed, scene, cfg)
                out["faults"].setdefault(fault, {})[str(seed)] = nums
                print(f"fault {fault} seed {seed}: {nums}", flush=True)
        finally:
            mod.binned_grads = orig
    del scene
    rscene, rcfg = sides.make_scene(ref, cell.config, inputs, device, **ov)
    for seed in args.control_seeds:
        show("control", seed, *run(ref, seed, rscene, rcfg, compare.Bf16()))
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
