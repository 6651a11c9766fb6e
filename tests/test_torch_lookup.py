"""K4's adjoint and the lookup kernels' launch plans on the CPU.

``lookup_rows_bwd_plain`` (what K4-bwd is held to on the card) against the
JAX package's custom adjoints ``_rows_bwd`` and ``_bsig_rows_bwd`` on the
same numpy inputs, and ``fwd_blocks`` / ``bwd_plan``, the plain functions
of the shapes and the SM count that size the kernels' grids and pick the
backward's accumulator.  Tolerance against JAX: 1e-2 of the entry's
sum of |ct| (JAX rounds the cotangent to bf16 before its one-hot product,
volumetric.py:97-105, a relative error of at most 2^-8 per row).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voxtracer.diff.volumetric import _bsig_rows_bwd, _rows_bwd
from voxtracer_torch.kernels import lookup

torch.set_num_threads(1)

H100_SMS = 132
# the path's shapes (chip_smoke.py [7]): the albedo rows of the largest core
# chunk and brick-sigma segments of the 1080p binned gradient
ALBEDO = (2_918_400, 256, 3)
BRICK_SIGMA = [(291_840, 2048, 1), (691_200, 2048, 1)]


def test_plan_privatises_the_albedo_rows():
    acc, blocks = lookup.bwd_plan(*ALBEDO, H100_SMS)
    assert acc == "shared"
    assert blocks == H100_SMS * lookup.BWD_BLOCKS_PER_SM


@pytest.mark.parametrize("shape", BRICK_SIGMA)
def test_plan_adds_brick_sigma_rows_directly(shape):
    assert lookup.bwd_plan(*shape, H100_SMS)[0] == "direct"


@pytest.mark.parametrize("sms", [1, 132])
def test_plans_are_total_over_edge_sizes(sms):
    for n in (0, 1, 31, 33, 255, 257, 10 ** 6, 2 ** 40):
        blocks = lookup.fwd_blocks(n, sms)
        assert 1 <= blocks <= sms * lookup.FWD_BLOCKS_PER_SM
        # every row has a warp: blocks x 8 warps x 128 rows, or the cap
        rows = blocks * (lookup.THREADS // 32) * lookup.SLAB_ROWS
        assert rows >= n or blocks == sms * lookup.FWD_BLOCKS_PER_SM
        for k in (1, 3, 256, 2048, 12_288, 10 ** 6):
            for c in (1, 3, 6, 16):
                acc, blocks = lookup.bwd_plan(n, k, c, sms)
                assert acc in ("shared", "direct")
                cap = sms * lookup.BWD_BLOCKS_PER_SM
                assert 1 <= blocks <= cap
                step = blocks * (lookup.THREADS // 32) * lookup.SLAB_ROWS
                assert step >= n or blocks == cap
                if acc == "shared":
                    assert 4 * k * c * 8 <= lookup.PRIV_MAX_BYTES and n >= k * blocks


def _within(got, want, ct_abs_sum):
    assert got.shape == want.shape
    assert np.all(np.abs(got - want) <= 1e-2 * ct_abs_sum + 1e-6)


@pytest.mark.parametrize("n", [1, 33, 20_000])
def test_bwd_plain_matches_jax_rows_bwd(n):
    """The albedo adjoint: few material ids, as the march's cell column
    gives them (MAT_NONE = 255 most), all in range."""
    rng = np.random.default_rng(n)
    idx = rng.choice([0, 2, 7, 12, 40, 255], n, p=[.05, .1, .1, .1, .05, .6]).astype(np.int32)
    ct = rng.normal(size=(n, 3)).astype(np.float32)
    want = np.asarray(_rows_bwd((jnp.asarray(idx), 256), jnp.asarray(ct))[0])
    got = lookup.lookup_rows_bwd_plain(torch.from_numpy(ct), torch.from_numpy(idx), 256)
    ref = lookup.lookup_rows_bwd_plain(torch.from_numpy(np.abs(ct)), torch.from_numpy(idx), 256)
    _within(got.numpy(), want, ref.numpy())
    assert np.abs(want).max() > 0


@pytest.mark.parametrize("n", [1, 4096])
def test_bwd_plain_matches_jax_bsig_rows_bwd(n):
    """The brick-sigma adjoint: ids spread over a [2048] table."""
    rng = np.random.default_rng(7 + n)
    idx = rng.integers(0, 2048, n).astype(np.int32)
    ct = rng.normal(size=n).astype(np.float32)
    want = np.asarray(_bsig_rows_bwd((jnp.asarray(idx), 2048), jnp.asarray(ct))[0])
    got = lookup.lookup_rows_bwd_plain(torch.from_numpy(ct[:, None]), torch.from_numpy(idx), 2048)
    ref = lookup.lookup_rows_bwd_plain(torch.from_numpy(np.abs(ct[:, None])),
                                       torch.from_numpy(idx), 2048)
    _within(got[:, 0].numpy(), want, ref[:, 0].numpy())


def test_out_of_range_ids_jax_drops_them_the_port_clips_them():
    """The documented difference (ROADMAP Queue 3): JAX's one-hot adjoint
    has no column for an id outside [0, K) and drops its row; the port's is
    the exact adjoint of the clipped gather and adds it to row 0 or K - 1,
    as autograd through ``lookup_rows_plain`` does.  The path's ids are
    always in range."""
    k = 8
    idx = np.array([-3, 1, k + 5, 1, k - 1], np.int32)
    ct = np.array([[1.0], [2.0], [4.0], [8.0], [16.0]], np.float32)
    jax_d = np.asarray(_rows_bwd((jnp.asarray(idx), k), jnp.asarray(ct))[0])[:, 0]
    port_d = lookup.lookup_rows_bwd_plain(torch.from_numpy(ct), torch.from_numpy(idx), k)[:, 0]
    tab = torch.zeros((k, 1), requires_grad=True)
    lookup.lookup_rows_plain(tab, torch.from_numpy(idx)).backward(torch.from_numpy(ct))
    np.testing.assert_array_equal(jax_d, [0, 10, 0, 0, 0, 0, 0, 16])
    np.testing.assert_array_equal(port_d.numpy(), [1, 10, 0, 0, 0, 0, 0, 20])
    torch.testing.assert_close(port_d, tab.grad[:, 0], rtol=0, atol=0)


def test_cpu_tensors_take_the_plain_versions_whatever_the_accumulator():
    rng = np.random.default_rng(3)
    tab = torch.from_numpy(rng.uniform(size=(256, 6)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(-9, 270, 1001).astype(np.int32))
    ct = torch.from_numpy(rng.normal(size=(1001, 6)).astype(np.float32))
    before = dict(lookup.launches)
    assert torch.equal(lookup.lookup_rows(tab, idx), lookup.lookup_rows_plain(tab, idx))
    for acc in ("shared", "direct"):
        assert torch.equal(lookup.lookup_rows_bwd(ct, idx, 256, acc=acc),
                           lookup.lookup_rows_bwd_plain(ct, idx, 256))
    assert lookup.launches == before
