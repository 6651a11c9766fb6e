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
