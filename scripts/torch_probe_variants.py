#!/usr/bin/env python3
"""The forms of the P1 (lane gather), P3 (chain gather) and P4 (ALU loop)
probe steps, timed side by side on one GPU over a sweep of the row count B:

    python scripts/torch_probe_variants.py [--out out/probe_variants]

Builds scripts/torch_probe_variants.cu with nvcc (the flags of
voxtracer_torch/kernels/build.py) into <out>/, writes ptxas' report and
the SASS (cuobjdump) there, holds every form to the plain version of
voxtracer_torch/kernels/probes.py at B = 1, 32, 256, 1024, SMs + 1 and
8 x SMs + 1 (P3's partial blocks and second wave) and several loop
counts, then times each at B = 32, 256, 1024 and every multiple of the SM
count from 2 to 8 (that many warps a scheduler), and P3 also at 16 x SMs
(where two blocks of its eight-copy form fit an SM and one of sixteen
copies does not): the per-launch time (chip_smoke.per_launch) at the
entry point's loop count k (P1 4,096, P3 512, P4 8,192) and at 2k, in two
rounds (the forms in order, then in reverse), and prints cycles an
iteration, (t(2k) - t(k)) / k at nvidia-smi's maximum SM clock, with the
SM clock read beside each pair.  Last, for each probe, the row counts at
which the short chain beats the few-ops form in both rounds and the
reverse (for P1 and P4, csrc/probes.cu's *_SHORT_CHAIN_WARPS).  Without a
CUDA device it raises.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import pathlib
import subprocess
import sys

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from chip_smoke import per_launch  # noqa: E402
from voxtracer_torch import probe  # noqa: E402
from voxtracer_torch.kernels import build, probes  # noqa: E402

P1_FORMS = {0: "copy, short chain", 1: "few ops", 2: "short chain"}
P3_FORMS = {0: "one copy", 1: "few ops", 2: "short chain", 3: "eight copies"}
P4_FORMS = {0: "four candidates", 1: "few ops", 2: "short chain"}
FORMS = {"P1": P1_FORMS, "P3": P3_FORMS, "P4": P4_FORMS}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="out/probe_variants")
    out_dir = pathlib.Path(ap.parse_args(argv).out)
    if not torch.cuda.is_available():
        raise RuntimeError("torch_probe_variants: no CUDA device; the variants run on the card")
    out_dir.mkdir(parents=True, exist_ok=True)
    card = probe.smi("name,power.limit")
    clock = float(probe.smi("clocks.max.sm").split()[0]) * 1e6
    print(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {card}, max SM clock "
          f"{clock / 1e6:.0f} MHz", flush=True)

    lib_path = out_dir / "libprobe_variants.so"
    nvcc = [build._nvcc(), *build.NVCC_FLAGS, "-shared", "-o", str(lib_path),
            str(ROOT / "scripts" / "torch_probe_variants.cu")]
    made = subprocess.run(nvcc, capture_output=True, text=True)
    (out_dir / "ptxas.txt").write_text(made.stdout + made.stderr)
    if made.returncode:
        raise RuntimeError(f"nvcc failed:\n{made.stdout}{made.stderr}")
    sass = subprocess.run([os.path.join(os.path.dirname(build._nvcc()), "cuobjdump"), "-sass",
                           str(lib_path)], capture_output=True, text=True)
    (out_dir / "sass.txt").write_text(sass.stdout + sass.stderr)
    lib = ctypes.CDLL(str(lib_path))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.pv_lane_gather.argtypes = [I, P, P, I, I, P]
    lib.pv_chain_gather.argtypes = [I, P, P, I, I, P]
    lib.pv_alu_loop.argtypes = [I, P, P, ctypes.c_longlong, I, P]
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)

    def p1(form, tab, idx, iters):
        out = torch.empty_like(idx)
        build.check(lib.pv_lane_gather(form, tab.data_ptr(), idx.data_ptr(), idx.shape[0],
                                       iters, out.data_ptr()), f"P1 {P1_FORMS[form]}")
        return out

    def p3(form, tab, idx, iters):
        out = torch.empty_like(idx)
        build.check(lib.pv_chain_gather(form, tab.data_ptr(), idx.data_ptr(), idx.shape[0],
                                        iters, out.data_ptr()), f"P3 {P3_FORMS[form]}")
        return out

    def p4(form, a, b, iters):
        out = torch.empty_like(a)
        build.check(lib.pv_alu_loop(form, a.data_ptr(), b.data_ptr(), a.numel(), iters,
                                    out.data_ptr()), f"P4 {P4_FORMS[form]}")
        return out

    def inputs(b):
        def wide():
            return torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31 - 1, (b, 128))
                                    .astype(np.int32)).to(dev)
        far = rng.uniform(size=(b, 128)) < 0.25
        y = np.where(far, rng.uniform(-1e9, 2e9, (b, 128)), rng.uniform(-100, 100, (b, 128)))
        ctab = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31 - 1, (16, 128))
                                .astype(np.int32)).to(dev)
        return ((wide(), wide()), (ctab, wide()),
                (wide(), torch.from_numpy(y.astype(np.float32)).to(dev)))

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    checked = (1, 32, 256, 1024, sms + 1, 8 * sms + 1)
    for b in checked:
        (tab, idx), (ctab, cidx), (a, f) = inputs(b)
        for iters in (0, 1, 5, 67, 4099):
            for pid, fn, args, plain in (("P1", p1, (tab, idx), probes.lane_gather_plain),
                                         ("P3", p3, (ctab, cidx), probes.chain_gather_plain),
                                         ("P4", p4, (a, f), probes.alu_loop_plain)):
                want = plain(*args, iters)
                for form, name in FORMS[pid].items():
                    if not torch.equal(fn(form, *args, iters), want):
                        raise AssertionError(f"{pid} {name} [B={b}, {iters}] differs")
    print(f"every form equals its plain version at B = {checked} and 0, 1, 5, 67, 4099 "
          f"iterations", flush=True)

    sweep = sorted({32, 256, 1024, *(w * sms for w in range(2, 9))})
    cycles = {}
    for b in sweep + [16 * sms]:
        (tab, idx), (ctab, cidx), (a, f) = inputs(b)
        runs = [(("P3", v), lambda k, v=v: p3(v, ctab, cidx, k), probe.START_K["P3"])
                for v in P3_FORMS]
        if b in sweep:
            runs += [(("P1", v), lambda k, v=v: p1(v, tab, idx, k), probe.START_K["P1"])
                     for v in P1_FORMS]
            runs += [(("P4", v), lambda k, v=v: p4(v, a, f, k), probe.START_K["P4"])
                     for v in P4_FORMS]
        got = {}
        for order in (runs, runs[::-1]):
            for key, fn, k in order:
                before = probe.smi("clocks.sm")
                t1, t2 = per_launch(lambda: fn(k))[0], per_launch(lambda: fn(2 * k))[0]
                got.setdefault(key, []).append((t1, t2, before, probe.smi("clocks.sm")))
        for (pid, v), fn, k in runs:
            g = got[pid, v]
            cyc = cycles[pid, v, b] = [(t2 - t1) * 1e-3 / k * clock for t1, t2, _, _ in g]
            name = FORMS[pid][v]
            print(f"B = {b} ({b / sms:.2f} warps a scheduler) {pid} {name}: "
                  f"{' / '.join(f'{c:.2f}' for c in cyc)} cycles an iteration (per launch at "
                  f"k = {k}: {' / '.join(f'{x[0]:.5f}' for x in g)} ms, at 2k: "
                  f"{' / '.join(f'{x[1]:.5f}' for x in g)} ms; clocks.sm "
                  f"{', '.join(f'{x[2]} -> {x[3]}' for x in g)}) ({card})", flush=True)
    for pid in ("P1", "P3", "P4"):
        short = [b for b in sweep if max(cycles[pid, 2, b]) < min(cycles[pid, 1, b])]
        few = [b for b in sweep if max(cycles[pid, 1, b]) < min(cycles[pid, 2, b])]
        print(f"{pid}: the short chain is faster in both rounds at B = {short}, few ops at B = "
              f"{few}; the short chain up to {max(short, default=0) // sms} warps a scheduler "
              f"({card})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
