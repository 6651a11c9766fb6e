#!/usr/bin/env python3
"""The program's spans in one cell: the cell's set-up as the harness makes
it, then ``--samples`` profiled iterations, each opened as the traced run
opens its samples (a profiler for two iterations, the first warming it
up, the second recorded), and the table by innermost ``vt.*`` span of the
recorded ones: device ms, launches and idle ms an iteration
(``vtbench/spans.py``), with the recorded iterations' wall.

    python3 vtbench/tools/spans.py --workload monu.frame --seed 7 \\
        --samples 3 --out chiprun_out/spans.monu.frame.json
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))

from vtbench import spans  # noqa: E402


def format_table(t: dict) -> str:
    """The table by innermost span, most device time first."""
    rows = sorted(t["by_span"].items(), key=lambda kv: -kv[1]["device_ms"])
    rows.append(("total", {f: sum(r[f] for _, r in rows) for f in spans.FIELDS}))
    lines = [f"{'span':<22}{'device ms':>12}{'launches':>10}{'idle ms':>10}"]
    for name, r in rows:
        lines.append(f"{name:<22}{r['device_ms']:>12.3f}{r['launches']:>10.0f}"
                     f"{r['idle_ms']:>10.3f}")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=2147483905)
    ap.add_argument("--samples", type=int, default=1)
    ap.add_argument("--out")
    args = ap.parse_args(argv)

    import torch

    from vtbench import harness, loops, sides, spec, trace

    device = torch.device("cuda")
    cell = spec.cell(args.workload)
    inputs = sides.make_inputs(cell.config)
    loop = loops.make(cell.traffic, args.seed, sides.has_media(inputs))
    prog = sides.Side(sides.PROGRAM)
    scene, cfg = sides.make_scene(prog, cell.config, inputs, device,
                                  **loops.render_overrides(cell.traffic))
    loop.setup(prog, scene, cfg, loop.make_inputs(cfg, device))
    harness.sync(device)

    rec = trace.Trace()
    i = loop.first
    for _ in range(args.samples):
        prof = harness._profiler(rec, device)
        prof.start()
        for _ in range(2):
            a = time.perf_counter()
            loop.step(i)
            harness.sync(device)
            rec.pending = (i, time.perf_counter() - a)
            prof.step()
            i += 1
        prof.stop()
    t = spans.table(rec.iterations)
    walls = [it.wall_s * 1e3 for it in rec.iterations]
    busy = [trace.union_ns((s, e) for _, s, e in it.device)[0] / 1e6 for it in rec.iterations]
    kind = torch.cuda.get_device_name(device)
    print(f"{args.workload} on {kind}: {len(walls)} recorded {loop.units()}, wall ms "
          f"median {statistics.median(walls):.3f} mean {statistics.fmean(walls):.3f} "
          f"({', '.join(f'{w:.3f}' for w in walls)}); device busy ms mean "
          f"{statistics.fmean(busy):.3f}")
    if t is None:
        print("no span figures (in every iteration the launch calls and the device "
              "operations differ in count)")
    else:
        if t["left_out"]:
            print(f"left out (counts differ): iterations {t['left_out']}")
        print(format_table(t))
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"workload": args.workload, "device": kind, "seed": args.seed,
                       "wall_ms": walls, "busy_ms": busy, "spans": t}, f, indent=1)
    return 0 if t is not None else 1


if __name__ == "__main__":
    sys.exit(main())
