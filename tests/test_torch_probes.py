"""The port's gather and ALU probes (voxtracer_torch.kernels.probes) against
the Pallas probe kernels of scripts/probe_pallas.py, on the CPU.

The script is loaded by path, its ``pl.pallas_call`` runs in interpret
mode and its ``diff_cost`` is replaced by one that captures the jitted
probe instead of timing it.  The captured probe then runs on seeded numpy
inputs (random tables, not the script's arange ones) at a few loop counts,
and the plain versions must give the same int32 results exactly.

P4 runs under ``jax.disable_jit()``, and there its kernel body runs op by
op on the script's refs, as torch runs it.  Interpret mode would not do:
it compiles the whole body as one XLA computation even under
``disable_jit``, and XLA's CPU backend contracts ``y * 1.0000001 + 0.5``
into a fused multiply-add, which moves ``x + int(y)`` on a few of the
2,048 elements (by up to 576 on these inputs).
"""

import functools
import importlib.util
import os
import pathlib
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
import numpy as np
import pytest
import torch

from voxtracer_torch.kernels import probes

torch.set_num_threads(1)
_ORIG_PALLAS_CALL = pl.pallas_call
ROOT = pathlib.Path(__file__).resolve().parent.parent
B = 16


class _Ref:
    """A kernel ref over one array: ``ref[i]`` reads, ``ref[...] = v``
    replaces."""

    def __init__(self, value=None):
        self.value = value

    def __getitem__(self, i):
        return self.value[i]

    def __setitem__(self, i, v):
        assert i is Ellipsis
        self.value = v


def _pallas_call(kernel, out_shape, **params):
    """pallas_call in interpret mode; under ``jax.disable_jit()`` the kernel
    body op by op."""
    interpreted = _ORIG_PALLAS_CALL(kernel, out_shape=out_shape, interpret=True, **params)

    def call(*args):
        if not jax.config.jax_disable_jit:
            return interpreted(*args)
        out = _Ref()
        kernel(*map(_Ref, args), out)
        return out.value

    return call


@pytest.fixture(scope="module")
def pallas_probes():
    """{probe: the script's jitted run(iters, *args)}."""
    spec = importlib.util.spec_from_file_location("probe_pallas",
                                                  ROOT / "scripts" / "probe_pallas.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    captured = {}

    def capture(fn, k, *args, unit_work=1):
        captured["fn"] = fn
        return 0.0, 0.0, 0.0

    mod.diff_cost = capture
    runs = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mod.pl, "pallas_call", _pallas_call)
        for name, start in (("P1", lambda: mod.p1_lane_gather(B=B)),
                            ("P3", lambda: mod.p3_chain_gather(B=B)),
                            ("P4", lambda: mod.p4_vpu_ops(B=B)),
                            ("X1", lambda: mod.x1_row_gather(n=4096, T=2048, W=16))):
            start()
            runs[name] = captured.pop("fn")
        yield runs


def _inputs(name, rng):
    """Seeded numpy inputs for probe `name`, any int32 where the probe
    takes any."""
    i32 = np.iinfo(np.int32)
    wide = functools.partial(rng.integers, i32.min, i32.max, dtype=np.int64)
    if name == "P1":
        return wide((B, 128)).astype(np.int32), wide((B, 128)).astype(np.int32)
    if name == "P3":
        return wide((16, 128)).astype(np.int32), wide((B, 128)).astype(np.int32)
    if name == "P4":
        far = rng.uniform(size=(B, 128)) < 0.25
        b = np.where(far, rng.uniform(-1e9, 2e9, (B, 128)), rng.uniform(-100, 100, (B, 128)))
        return wide((B, 128)).astype(np.int32), b.astype(np.float32)
    return rng.integers(0, 2 ** 20, (2048, 16)).astype(np.int32), wide(4096).astype(np.int32)


PORT = {"P1": probes.lane_gather_plain, "P3": probes.chain_gather_plain,
        "P4": probes.alu_loop_plain, "X1": probes.row_gather}


@pytest.mark.parametrize("iters", [1, 3, 17])
@pytest.mark.parametrize("name", ["P1", "P3", "P4", "X1"])
def test_plain_probes_match_pallas(pallas_probes, name, iters):
    args = _inputs(name, np.random.default_rng([iters, list(PORT).index(name)]))
    run = functools.partial(pallas_probes[name], jnp.int32(iters), *map(jnp.asarray, args))
    if name == "P4":
        with jax.disable_jit():
            want = np.asarray(run())
    else:
        want = np.asarray(run())
    got = PORT[name](*map(torch.from_numpy, args), iters)
    assert got.dtype == torch.int32
    if name == "X1":  # the script's X1 returns acc.sum() in int32
        got = np.int64(got.sum().item()).astype(np.int32)
        assert got == want
    else:
        np.testing.assert_array_equal(got.numpy(), want)


def test_wrappers_take_the_plain_version_on_the_cpu():
    rng = np.random.default_rng(5)
    tab = torch.from_numpy(rng.integers(0, 1000, (4, 128)).astype(np.int32))
    idx = torch.from_numpy(rng.integers(0, 128, (4, 128)).astype(np.int32))
    before = dict(probes.launches)
    assert torch.equal(probes.lane_gather(tab, idx, 5), probes.lane_gather_plain(tab, idx, 5))
    ctab = torch.arange(2048, dtype=torch.int32).reshape(16, 128)
    assert torch.equal(probes.chain_gather(ctab, idx, 5),
                       probes.chain_gather_plain(ctab, idx, 5))
    b = torch.ones((4, 128), dtype=torch.float32)
    assert torch.equal(probes.alu_loop(idx, b, 5), probes.alu_loop_plain(idx, b, 5))
    assert probes.launches == before


def test_probe_entry_point_needs_a_card():
    out = subprocess.run([sys.executable, "-m", "voxtracer_torch.probe"], cwd=str(ROOT),
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr
    assert "ns/idx" not in out.stdout


# ---- csrc/probes.cu's loop bodies, transcribed step by step in numpy and
# held against the plain versions and the Pallas probes

U32 = np.uint32
S, HALF, BIG = np.float32(1.0000001), np.float32(0.5), np.float32(1e9)
SKEW, OFFSET_MASK = 32, U32(0x3FFF)
CHAIN_COPIES, CHAIN_MASK = 16, U32(0x1FFFF)


def _cu_threshold():
    """P4's thresholds in csrc/probes.cu (selp.f32 thr, <under !m>, <under m>)."""
    src = (ROOT / "voxtracer_torch" / "csrc" / "probes.cu").read_text()
    m = re.search(r"selp\.f32 thr, 0f([0-9A-F]{8}), 0f([0-9A-F]{8}), nm;", src)
    big, under_m = (np.array([int(h, 16)], np.uint32).view(np.float32)[0] for h in m.groups())
    return big, under_m


def _step1(y):
    """y * 1.0000001f + 0.5f, two roundings as the kernel's FMUL and FADD."""
    return (y * S) + HALF


def lane_gather_skewed(tab, idx, iters, short_chain):
    """P1 as the kernel computes it: the row staged 32 times lane-skewed
    (entry e for lane l at word e * 32 + l), the index carried as the byte
    offset index * 128 + lane * 4, and one of the two forms of the step."""
    words = np.repeat(tab.view(U32), SKEW, axis=1)
    rows = np.arange(tab.shape[0])[:, None]
    off = ((idx.view(U32) & U32(127)) << U32(7)) | ((np.arange(128, dtype=U32) % SKEW) << U32(2))
    q, acc = off.copy(), np.zeros_like(off)
    for _ in range(iters):
        v = words[rows, off >> U32(2)]
        if short_chain:  # q = off + acc * 128, formed while the load is in flight
            off = ((v << U32(7)) + q) & OFFSET_MASK
            acc = acc + v
            q = off + (acc << U32(7))
        else:
            acc = acc + v
            off = (off + (acc << U32(7))) & OFFSET_MASK
    return acc.view(np.int32)


def chain_gather_skewed(tab, idx, iters, short_chain, reads=None):
    """P3 as the kernel computes it: the 2,048-entry table staged once per
    lane class (lane % 16; entry e for class c at word e * 16 + c), the
    index carried as the byte offset e * 64 + c * 4, and one of the two
    forms of the step.  With `reads`, the word address of every load, one
    [B, 128] array a step, is appended to it."""
    words = np.repeat(tab.reshape(-1).view(U32), CHAIN_COPIES)
    lane_class = np.arange(128, dtype=U32) % CHAIN_COPIES
    off = ((idx.view(U32) & U32(2047)) << U32(6)) | (lane_class << U32(2))
    q, acc = off.copy(), np.zeros_like(off)
    for _ in range(iters):
        if reads is not None:
            reads.append(off >> U32(2))
        v = words[off >> U32(2)]
        if short_chain:  # q = off + acc * 64, formed while the load is in flight
            off = ((v << U32(6)) + q) & CHAIN_MASK
            acc = acc + v
            q = off + (acc << U32(6))
        else:
            acc = acc + v
            off = (off + (acc << U32(6))) & CHAIN_MASK
    return acc.view(np.int32)


def _fullest_bank(word_addrs):
    """The most distinct words any one of the 32 banks holds in any warp's
    load: word_addrs [..., 128] (a row's 128 lanes are its 4 warps)."""
    warps = word_addrs.reshape(-1, 32)
    return max(max(np.unique(w[w % 32 == bank]).size for bank in range(32)) for w in warps)


def alu_loop_steps(a, b, iters, short_chain):
    """P4 as the kernel computes it: m from bit 4 of x, x + 1 + bit 4, y's
    FMUL, FADD under m, then m2 (the short chain: read from y before the
    step against the threshold m selects; few ops: y1 < 1e9 after the add),
    the xor under m2 and y's FMUL by 0.5 under !m2."""
    big, under_m = _cu_threshold()
    x, y = a.view(U32).copy(), b.copy()
    with np.errstate(over="ignore", invalid="ignore"):
        for _ in range(iters):
            nm = (x & U32(16)) != 0
            if short_chain:
                m2 = y < np.where(nm, big, under_m)
            xm = np.where(nm, x + U32(2), x + U32(1))
            y = np.where(nm, y, _step1(y))
            if not short_chain:
                m2 = y < BIG
            x = np.where(m2, xm ^ (xm.view(np.int32) >> 3).view(U32), xm)
            y = np.where(m2, y, y * HALF)
        # __float2int_rz: toward zero, saturating at the int32 range
        yi = np.clip(y.astype(np.float64), -2.0 ** 31, 2.0 ** 31 - 1).astype(np.int64)
    return (x.astype(np.int64) + yi).astype(U32).view(np.int32)


def test_p4_threshold_is_where_the_step_reaches_1e9():
    """y * 1.0000001f + 0.5f < 1e9 exactly when y < the kernel's threshold:
    the step is monotone in y, the threshold is the least float it takes to
    1e9, and a sweep of the floats around it and of random bit patterns
    agrees."""
    big, under_m = _cu_threshold()
    assert big == BIG
    below = np.nextafter(under_m, np.float32(-np.inf))
    assert _step1(below) < BIG <= _step1(under_m)
    lo, hi = np.array([9.9e8, 1.01e9], np.float32).view(U32)
    near = np.arange(lo, hi, dtype=U32).view(np.float32)
    bits = np.random.default_rng(7).integers(0, 2 ** 32, 1 << 20, dtype=np.uint64).astype(U32)
    extremes = np.array([np.inf, -np.inf, np.finfo(np.float32).max,
                         -np.finfo(np.float32).max, 0.0, -0.0], np.float32)
    with np.errstate(over="ignore", invalid="ignore"):
        for y in (near, bits.view(np.float32), extremes):
            np.testing.assert_array_equal(y < under_m, _step1(y) < BIG)


def _p4_edge_inputs(rng):
    """P4's inputs with the floats that cross 1e9 and the threshold put in."""
    a, b = _inputs("P4", rng)
    big, under_m = _cu_threshold()
    edges = [under_m, np.nextafter(under_m, np.float32(0)), big, np.nextafter(big, np.float32(0)),
             np.nextafter(big, np.float32(3e9)), 2e9, -2e9, 1.9999999e9, 5e8, -0.0]
    b[0, :len(edges)] = edges
    return a, b


@pytest.mark.parametrize("iters", [0, 1, 3, 5, 17])
@pytest.mark.parametrize("form", ["P1 short chain", "P1 few ops", "P3 short chain",
                                  "P3 few ops", "P4 short chain", "P4 few ops"])
def test_kernel_steps_match_plain_and_pallas(pallas_probes, form, iters):
    """Each loop body of csrc/probes.cu, transcribed step by step, against
    the plain version and the Pallas probe (interpret mode; P4 op by op),
    over wide int32 inputs and P4's near and far floats, at loop counts that
    cover the 4-step unroll and its remainder."""
    rng = np.random.default_rng([iters, len(form)])
    if form.startswith("P4"):
        args = _p4_edge_inputs(rng)
        got = alu_loop_steps(*args, iters, short_chain=form == "P4 short chain")
        plain = probes.alu_loop_plain(*map(torch.from_numpy, args), iters)
        with jax.disable_jit():
            want = np.asarray(pallas_probes["P4"](jnp.int32(iters), *map(jnp.asarray, args)))
    elif form.startswith("P3"):
        args = _inputs("P3", rng)
        got = chain_gather_skewed(*args, iters, short_chain=form == "P3 short chain")
        plain = probes.chain_gather_plain(*map(torch.from_numpy, args), iters)
        want = np.asarray(pallas_probes["P3"](jnp.int32(iters), *map(jnp.asarray, args)))
    else:
        args = _inputs("P1", rng)
        got = lane_gather_skewed(*args, iters, short_chain=form == "P1 short chain")
        plain = probes.lane_gather_plain(*map(torch.from_numpy, args), iters)
        want = np.asarray(pallas_probes["P1"](jnp.int32(iters), *map(jnp.asarray, args)))
    np.testing.assert_array_equal(got, plain.numpy())
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("warps", ["random", "adversarial"])
def test_p3_layout_puts_at_most_two_words_in_a_bank(warps):
    """Every load of the P3 transcription, in every warp and at every step,
    puts at most 2 distinct words in any one bank: 16 lane-class copies
    give each class two banks.  The adversarial warps read 32 distinct
    entries of one parity, all 0 mod 32 (a table of even values keeps them
    even): there one copy of the table would put all 32 words in one bank."""
    rng = np.random.default_rng(21)
    for short_chain in (True, False):
        if warps == "random":
            tab, idx = _inputs("P3", rng)
        else:
            tab = (rng.integers(0, 2 ** 30, (16, 128)) * 2).astype(np.int32)
            idx = np.tile((np.arange(32) * 64).astype(np.int32), (B, 4))
            assert _fullest_bank(idx) == 32  # one copy: entry e in bank e % 32
        reads = []
        chain_gather_skewed(tab, idx, 17, short_chain, reads)
        assert len(reads) == 17
        assert max(_fullest_bank(r) for r in reads) == 2


def test_p4_steps_match_plain_at_the_float_extremes():
    """Infinities, the largest floats and signed zeros (where y * 1.0000001f
    overflows) through the P4 transcription and the plain version."""
    rng = np.random.default_rng(11)
    a, b = _inputs("P4", rng)
    fmax = np.finfo(np.float32).max
    b[:, :8] = np.array([np.inf, -np.inf, fmax, -fmax, np.nextafter(fmax, np.float32(0)),
                         0.0, -0.0, 1e-45], np.float32)
    for iters in (1, 5, 200):
        want = probes.alu_loop_plain(*map(torch.from_numpy, (a, b)), iters).numpy()
        for short_chain in (True, False):
            np.testing.assert_array_equal(alu_loop_steps(a, b, iters, short_chain), want)


def test_ptxas_report_names_each_probe_kernel():
    """chip_smoke.py reads ptxas' report per kernel instance: each form of
    P1's and P4's step, and P3's copies and form, named from the mangled
    symbol, with its registers, stack frame and spills."""
    import chip_smoke

    prefix = "_ZN41_GLOBAL__N__bd669c93_9_probes_cu_f7074944"
    symbols = {"19chain_gather_kernelILi16ELb1EEEvPKiS2_iiPi":
               "chain_gather_kernel<16 copies, short chain>",
               "19chain_gather_kernelILi8ELb0EEEvPKiS2_iiPi":
               "chain_gather_kernel<8 copies, few ops>",
               "18lane_gather_kernelILb1EEEvPKiS2_iPi": "lane_gather_kernel<short chain>",
               "15alu_loop_kernelILb0EEEvPKiPKfxiPi": "alu_loop_kernel<few ops>"}
    log = "".join(f"ptxas info    : Function properties for {prefix}{sym}\n"
                  f"    0 bytes stack frame, {i} bytes spill stores, 0 bytes spill loads\n"
                  f"ptxas info    : Used {20 + i} registers, used 1 barriers\n"
                  for i, sym in enumerate(symbols))
    got = chip_smoke.ptxas_functions(log)
    assert [f["name"] for f in got] == list(symbols.values())
    assert [(f["registers"], f["stack"], f["spill_stores"]) for f in got] == [
        (20 + i, 0, i) for i in range(len(symbols))]
