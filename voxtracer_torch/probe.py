"""Measure the card's gather and ALU rates:

    python -m voxtracer_torch.probe

The counterpart of scripts/probe_pallas.py on one NVIDIA GPU, through the
kernels of csrc/probes.cu.  It prints the device, nvidia-smi's name and
power limit, and then:

  P0  one launch's fixed cost: the host round trip of a tiny launch
      (launch + synchronise), and the CUDA-event time of one call of an
      empty kernel (alu_loop with 0 iterations), which on an idle stream
      takes in the wrapper's host time between the two events;
  X1  PyTorch's row gather from a [2048, 16] table over n = 2^20 indices,
      the yardstick the gathers are read against;
  P1  lane gather from a 128-entry row (kernels.probes.lane_gather),
      B = 256, 32 and 1024, each line naming the form of the step taken;
  P3  gather from a 2048-entry table (chain_gather), B = 256, 32 and
      1024;
  P4  DDA-shaped int/f32 loop (alu_loop), B = 256, 32 and 1024, the same.

The script's P2 (sublane gather, form 1) has no pallas_call, so it has no
counterpart here.

Each cost is (t(2k) - t(k)) / (k * work) in ns per index and iteration,
each t the CUDA-event median of 7 calls after a warm-up, so the launch
constant cancels.  k starts at the script's count (P1 4096, P3 512,
P4 8192, X1 8) and doubles until t(k) >= 1 ms.  Beside each cost stands
its bound, the least time per index and iteration the card's SMs allow at
nvidia-smi's maximum SM clock: the larger of the shared-memory (or L1)
loads over 32 four-byte loads per clock per SM, the int32 operations over
64 int32 lanes per SM, and all operations over the 128 threads per clock
per SM that the four warp schedulers dispatch; and the share of it
reached.  Beside each cost stand the cycles one iteration of the loop
takes over the whole launch (ns per index times the indices, at the
maximum SM clock) and nvidia-smi's SM clock read before and after the
measurement.  Without a CUDA device it raises: a measurement does not
fall back to the CPU.
"""

from __future__ import annotations

import statistics
import subprocess
import time

import numpy as np
import torch

from voxtracer_torch.kernels import probes

LOADS_PER_CLOCK = 32   # four-byte shared-memory / L1 loads per clock per SM
INT32_LANES = 64       # int32 lanes per SM
DISPATCH_LANES = 128   # 4 warp schedulers x 32 threads per clock per SM

# per index and iteration, counted from each loop body: (table loads, int32
# operations, all operations).  P1, P3 and P4: the instructions of the
# fewer-op form of the step in csrc/probes.cu's SASS (P4: 9, of them 5
# integer; P3's 3-op form is weighed in scripts/torch_probe_variants.py).
# A load is counted as one wavefront, the least a gather can take.
COUNTS = {"X1": (2, 4, 6), "P1": (1, 3, 4), "P3": (1, 3, 4), "P4": (0, 5, 9)}
# the script's loop counts, where k starts
START_K = {"X1": 8, "P1": 4096, "P3": 512, "P4": 8192}
# the kernel (kernels.probes) behind each probe
KERNELS = {"P1": "lane_gather", "P3": "chain_gather", "P4": "alu_loop"}


def log(*a):
    print(*a, flush=True)


def smi(fields: str) -> str:
    """nvidia-smi's first line for --query-gpu=fields."""
    out = subprocess.run(["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def event_ms(fn, reps=7):
    """Median CUDA-event time of fn() in ms over `reps` calls after one
    warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def diff_cost(fn, k, work):
    """(t(2k) - t(k)) / (k * work) in ns, k doubled until t(k) >= 1 ms
    -> (ns, k, t(k) ms, t(2k) ms)."""
    t1 = event_ms(lambda: fn(k))
    while t1 < 1.0:
        k *= 2
        t1 = event_ms(lambda: fn(k))
    t2 = event_ms(lambda: fn(2 * k))
    return (t2 - t1) * 1e6 / (k * work), k, t1, t2


def bound_ns(probe, sms, clock_hz):
    """The least ns per index and iteration on `sms` SMs at `clock_hz`, and
    what sets it."""
    loads, int_ops, all_ops = COUNTS[probe]
    per_clock = sms * clock_hz
    cands = {"loads": loads / (LOADS_PER_CLOCK * per_clock),
             "int32 ops": int_ops / (INT32_LANES * per_clock),
             "dispatch": all_ops / (DISPATCH_LANES * per_clock)}
    by = max(cands, key=cands.get)
    return cands[by] * 1e9, by


def main():
    """Run the probes on CUDA device 0, print one line each and return
    them as dicts (probe, B, ns, k, t1_ms, t2_ms, bound_ns, bound_by,
    cycles, clocks_sm)."""
    if not torch.cuda.is_available():
        raise RuntimeError("voxtracer_torch.probe: no CUDA device; the probes measure the card")
    dev = torch.device("cuda", 0)
    card = smi("name,power.limit")
    clock = float(smi("clocks.max.sm").split()[0]) * 1e6
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    log(f"device: {torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}, {sms} SMs, "
        f"max SM clock {clock / 1e6:.0f} MHz (torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}); nvidia-smi: {card}")
    rng = np.random.default_rng(0)

    def i32(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)

    z = torch.zeros((8, 128), device=dev)
    z8 = torch.zeros((8, 128), dtype=torch.int32, device=dev)
    round_trips = []
    for _ in range(8):
        t0 = time.perf_counter()
        z.add_(1.0)
        torch.cuda.synchronize()
        round_trips.append((time.perf_counter() - t0) * 1e3)
    empty = event_ms(lambda: probes.alu_loop(z8, z, 0))
    log(f"P0 one launch: host round trip (launch + synchronise) median "
        f"{statistics.median(round_trips[1:]) * 1e3:.1f} us; CUDA-event time of one "
        f"empty-kernel call, wrapper included, {empty * 1e3:.1f} us ({card})")

    results = []

    def run(probe, label, b, fn, work):
        before = smi("clocks.sm")
        ns, k, t1, t2 = diff_cost(fn, START_K[probe], work)
        clocks = (before, smi("clocks.sm"))
        bound, by = bound_ns(probe, sms, clock)
        cycles = ns * 1e-9 * work * clock
        results.append(dict(probe=probe, B=b, ns=ns, k=k, t1_ms=t1, t2_ms=t2,
                            bound_ns=bound, bound_by=by, cycles=cycles, clocks_sm=clocks))
        log(f"{label}: {ns:.5f} ns/idx (k={k}: t(k) {t1:.3f} ms, t(2k) {t2:.3f} ms); "
            f"bound {bound:.6f} ns/idx ({by}), {bound / ns:.2%} of it reached; "
            f"{cycles:.2f} cycles an iteration at {clock / 1e6:.0f} MHz (clocks.sm "
            f"{clocks[0]} -> {clocks[1]}) ({card})")

    n, t, w = 1 << 20, 2048, 16
    xtab, xidx = i32(rng.integers(0, 2 ** 20, (t, w))), i32(rng.integers(0, t, n))
    run("X1", f"X1 PyTorch row gather [{t},{w}] x {n}", n,
        lambda k: probes.row_gather(xtab, xidx, k), n)
    for b in (256, 32, 1024):
        tab = i32(np.broadcast_to(np.arange(128), (b, 128)))
        idx = i32(rng.integers(0, 128, (b, 128)))
        run("P1", f"P1 lane gather 128-entry rows [B={b}, {probes.form('lane_gather', b)}]", b,
            lambda k: probes.lane_gather(tab, idx, k), b * 128)
    ctab = i32(np.arange(2048).reshape(16, 128))
    for b in (256, 32, 1024):
        cidx = i32(rng.integers(0, 2048, (b, 128)))
        run("P3", f"P3 gather 2048-entry table [B={b}]", b,
            lambda k: probes.chain_gather(ctab, cidx, k), b * 128)
    for b in (256, 32, 1024):
        a = torch.ones((b, 128), dtype=torch.int32, device=dev)
        f = torch.ones((b, 128), dtype=torch.float32, device=dev)
        run("P4", f"P4 DDA-shaped loop [B={b}, {probes.form('alu_loop', b)}]", b,
            lambda k: probes.alu_loop(a, f, k), b * 128)
    return results


if __name__ == "__main__":
    main()
