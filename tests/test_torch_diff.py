"""The port's relaxed-march gradient step against the JAX package's, on the
CPU, and against finite differences of its own loss.

Both packages get the very same arrays: the monu-like scene at 128x32
with 16^3 noise volumes (the JAX SceneData, flattened to numpy and carried
over with ``scene_from_numpy``), the same DiffParams
(``diff_params_from_numpy``), and, for the binned gradients, the same
compacted rays, sky, target rows and spans.

Tolerances, each with its reason:
* host helpers (max_aabb_crossings, active_ray_permutation,
  span_cells_bins): equal, since both run the same numpy code;
* _occupied_spans: within 1e-6;
* _brick_mean_sigma: within 1e-6 (relative) of the exact float64 mean
  and 5e-6 of the JAX package's, whose f32 sum of 512 cells is itself
  3.7e-6 off the exact mean here (the port's 9.6e-7);
* forward images: rtol = atol = 1e-5;
* gradients: density cosine >= 0.9999 and relative L2 <= 1e-2; albedo
  relative L2 <= 1e-2.  The JAX adjoints of the albedo and brick-sigma
  rows round the cotangent to bf16 (about 0.4% per entry); the port sums
  in f32.  Measured here: binned density rel-L2 7.4e-6 and 2.0e-6,
  albedo 1.0e-3 and 2.7e-4; dense density 2.2e-7, albedo 8.1e-5.
* one Adam step: params within 1e-5 of optax's.

The dense per-pair march puts samples exactly on cell boundaries (at
n_steps = 8 the middle samples of a face-to-face crossing of a 16^3 grid
land on integer cell coordinates), where the multiply-adds XLA's CPU
backend contracts under jit flip cells.  There the JAX reference runs op
by op (``disable_jit``), which equals the port to 4e-7.  The union-span
march's samples do not sit on boundaries, and the JAX reference runs
under jit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_render import _flatten, _jax_scene
from voxtracer.config import RenderConfig as JaxConfig
from voxtracer.diff import volumetric as jv
from voxtracer.render.camera import primary_rays as jax_primary_rays
from voxtracer.render.sky import sample_sky as jax_sample_sky
from voxtracer_torch.config import RenderConfig
from voxtracer_torch.core.types import MAT_NONE
from voxtracer_torch.diff import train
from voxtracer_torch.diff import volumetric as tv
from voxtracer_torch.kernels.lookup import (LookupRows, lookup_rows_bwd,
                                            lookup_rows_bwd_plain)
from voxtracer_torch.render.camera import primary_rays_np
from voxtracer_torch.scene.convert import diff_params_from_numpy, scene_from_numpy

torch.set_num_threads(1)

W, H = 128, 32
BIN_STEPS, EDGES = (2, 10), (4.0,)  # the bench's (2,10)-step bins at edge 4
DENSE_STEPS = 8


def _np_params(p):
    return {f.name: np.asarray(getattr(p, f.name)) for f in dataclasses.fields(p)}


def _cos_rel(got, want):
    a = np.asarray(got, np.float64).ravel()
    b = np.asarray(want, np.float64).ravel()
    return (float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b))),
            float(np.linalg.norm(a - b) / np.linalg.norm(b)))


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def world():
    js = _jax_scene("monu_like", W, H)
    jscene = jax.tree.map(jnp.asarray, js)
    jcfg = JaxConfig(width=W, height=H, mode="path", max_bounces=4)
    jp = jv.params_from_scene(jscene)
    tscene = scene_from_numpy(_flatten(js))
    tcfg = RenderConfig(width=W, height=H, mode="path", max_bounces=4)
    k = jv.max_aabb_crossings(jscene, jcfg)
    return dict(jscene=jscene, jcfg=jcfg, jp=jp, tscene=tscene, tcfg=tcfg, k=k,
                tp=diff_params_from_numpy(_np_params(jp)))


@pytest.fixture(scope="module")
def band(world):
    """The bench's precompute for the first of 2 bands, made by the JAX
    package: per bin (bin_index, n_active, o, d, bg, target, spans)."""
    jscene, jcfg = world["jscene"], world["jcfg"]
    rows = H // 2
    px, py = jnp.meshgrid(jnp.arange(W, dtype=jnp.float32),
                          jnp.arange(rows, dtype=jnp.float32))
    o, d = jax_primary_rays(jscene.camera, W, H, px.reshape(-1), py.reshape(-1), None, jnp)
    target = np.random.default_rng(0).uniform(size=(rows * W, 3)).astype(np.float32)
    out = []
    for bi, perm, _, na in jv.span_cells_bins(jscene, jcfg, row0=0, rows=rows, edges=EDGES):
        sel = jnp.asarray(perm[:min(-(-na // 1024) * 1024, o.shape[0])])
        oc, dc = jnp.take(o, sel, axis=0), jnp.take(d, sel, axis=0)
        bg = jax_sample_sky(jscene.sky, dc, jcfg.activate_sky, jcfg.sky_fallback)
        out.append(dict(bi=bi, na=na, o=oc, d=dc, bg=bg, target=jnp.asarray(target)[sel],
                        spans=jv.spans_for_rays(jscene, oc, dc)))
    return dict(rows=rows, target=target, bins=out, denom=float(rows * W * 3))


@pytest.fixture(scope="module")
def dense_grads(world):
    """jax.grad of the dense render_diff MSE, op by op, and its target."""
    target = np.random.default_rng(1).uniform(size=(H, W, 3)).astype(np.float32)
    with jax.disable_jit():
        g = jax.grad(jv.mse_loss)(world["jp"], world["jscene"], world["jcfg"],
                                  jnp.asarray(target), jax.random.PRNGKey(0), DENSE_STEPS)
    return target, g


# ---------------------------------------------------------------- host helpers

def test_host_helpers_equal(world):
    jscene, jcfg, tscene, tcfg = (world[x] for x in ("jscene", "jcfg", "tscene", "tcfg"))
    assert tv.max_aabb_crossings(tscene, tcfg) == world["k"] == 2
    want, got = jv.active_ray_permutation(jscene, jcfg), tv.active_ray_permutation(tscene, tcfg)
    np.testing.assert_array_equal(want[0], got[0])
    np.testing.assert_array_equal(want[1], got[1])
    assert want[2] == got[2] > 0
    for r0 in (0, H // 2):
        want = jv.span_cells_bins(jscene, jcfg, row0=r0, rows=H // 2, edges=EDGES)
        got = tv.span_cells_bins(tscene, tcfg, row0=r0, rows=H // 2, edges=EDGES)
        assert [w[0] for w in want] == [g[0] for g in got] == [0, 1]
        for w, g in zip(want, got):
            assert w[3] == g[3]
            np.testing.assert_array_equal(w[1], g[1])
            np.testing.assert_array_equal(w[2], g[2])


def test_primary_rays_np_bit_equal(world):
    g = np.random.default_rng(2).uniform(0, W, (2, 500)).astype(np.float32)
    cam = jax.tree.map(np.asarray, world["jscene"].camera)
    want = jax_primary_rays(cam, W, H, g[0], g[1], None, np)
    got = primary_rays_np(world["tscene"].camera, W, H, g[0], g[1])
    for w, x in zip(want, got):
        np.testing.assert_array_equal(w, x)


def test_occupied_spans_and_brick_sigma(world, band):
    jscene, tscene = world["jscene"], world["tscene"]
    o, d = band["bins"][1]["o"], band["bins"][1]["d"]
    inv = jscene.volumes.inv
    vo = np.asarray(jnp.einsum("vij,nj->vni", inv[:, :3, :3], o) + inv[:, None, :3, 3])
    vd = np.asarray(jnp.einsum("vij,nj->vni", inv[:, :3, :3], d))
    comps = [vo[..., 0], vo[..., 1], vo[..., 2], vd[..., 0], vd[..., 1], vd[..., 2]]
    want = jv._occupied_spans(jscene, *map(jnp.asarray, comps))
    got = tv._occupied_spans(tscene, *map(_t, comps))
    for w, g in zip(want, got):
        assert (np.asarray(w) < 1e33).any()
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)
    for w, g in zip(band["bins"][1]["spans"], tv.spans_for_rays(tscene, _t(o), _t(d))):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)
    got = tv._brick_mean_sigma(world["tp"], tscene, 512.0).numpy()
    sig = tv.softplus(world["tp"].density_logits).double() * 512.0
    exact = sig.reshape(4, 2, 8, 2, 8, 2, 8).mean(dim=(2, 4, 6)).reshape(-1).numpy()
    np.testing.assert_allclose(got, exact, rtol=1e-6, atol=0)
    want = np.asarray(jv._brick_mean_sigma(world["jp"], jscene, 512.0))
    np.testing.assert_allclose(got, want, rtol=5e-6, atol=0)


def test_prepare_bins_matches_bench_precompute(world, band):
    target = np.concatenate([band["target"].reshape(band["rows"], W, 3)] * 2)
    plan = train.prepare_bins(world["tscene"], world["tcfg"], target, BIN_STEPS, EDGES, tiles=2)
    assert plan.k == world["k"] and plan.denom == band["denom"]
    assert [(b.steps, b.clamp) for b in plan.bins[:2]] == [(2, False), (10, True)]
    for want, got in zip(band["bins"], plan.bins):
        assert got.n_active == want["na"]
        for f in ("o", "d", "bg", "target"):
            np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(want[f]))
        for w, g in zip(want["spans"], got.spans):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------- forward

def test_render_diff_dense_matches_jax(world):
    with jax.disable_jit():
        want = jv.render_diff(world["jp"], world["jscene"], world["jcfg"],
                              jax.random.PRNGKey(0), DENSE_STEPS)
    got = tv.render_diff(world["tp"], world["tscene"], world["tcfg"], DENSE_STEPS)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("compact", [False, True])
def test_render_diff_span_matches_jax(world, compact):
    kw = dict(n_steps=10, k=world["k"], span_steps=1)
    if compact:
        perm, inv_perm, na = jv.active_ray_permutation(world["jscene"], world["jcfg"])
        jkw = dict(perm=jnp.asarray(perm), inv_perm=jnp.asarray(inv_perm), n_active=na)
        tkw = dict(perm=perm, inv_perm=inv_perm, n_active=na)
    else:
        jkw = tkw = {}
    want = jv.render_diff(world["jp"], world["jscene"], world["jcfg"],
                          jax.random.PRNGKey(0), **kw, **jkw)
    got = tv.render_diff(world["tp"], world["tscene"], world["tcfg"], **kw, **tkw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_render_diff_active_matches_jax(world, band):
    b = band["bins"][1]
    kw = dict(k=world["k"], span_steps=1, clamp=True)
    want = jv.render_diff_active(world["jp"], world["jscene"], world["jcfg"], b["o"], b["d"],
                                 b["bg"], BIN_STEPS[1], spans=b["spans"], **kw)
    got = tv.render_diff_active(world["tp"], world["tscene"], _t(b["o"]), _t(b["d"]),
                                _t(b["bg"]), BIN_STEPS[1],
                                spans=tuple(map(_t, b["spans"])), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------- gradients

_mse_active_grad = jax.jit(jax.grad(jv.mse_loss_active),
                           static_argnames=("cfg", "n_steps", "k", "span_steps", "clamp",
                                            "n_active"))


def _hold_grads(got, want, cos_min=0.9999, rel_max=1e-2):
    cos, rel = _cos_rel(got.density_logits, want.density_logits)
    assert cos >= cos_min and rel <= rel_max, ("density", cos, rel)
    _, rel = _cos_rel(got.albedo_table, want.albedo_table)
    assert rel <= rel_max, ("albedo", rel)


@pytest.mark.parametrize("which", [0, 1])
def test_binned_grads_match_jax(world, band, which):
    b = band["bins"][which]
    kw = dict(k=world["k"], span_steps=1, clamp=b["bi"] > 0, n_active=b["na"])
    steps = BIN_STEPS[b["bi"]]
    want = _mse_active_grad(world["jp"], world["jscene"], world["jcfg"], b["o"], b["d"],
                            b["bg"], b["target"], band["denom"], steps, spans=b["spans"], **kw)
    _, got = tv.value_and_grad(tv.mse_loss_active)(
        world["tp"], world["tscene"], _t(b["o"]), _t(b["d"]), _t(b["bg"]), _t(b["target"]),
        band["denom"], steps, spans=tuple(map(_t, b["spans"])), **kw)
    assert np.abs(got.density_logits.numpy()).max() > 0
    _hold_grads(got, want)


def test_dense_grad_matches_jax(world, dense_grads):
    target, want = dense_grads
    _, got = tv.value_and_grad(tv.mse_loss)(world["tp"], world["tscene"], world["tcfg"],
                                            _t(target), DENSE_STEPS)
    _hold_grads(got, want)


def test_train_step_matches_optax_adam(world, dense_grads):
    target, g = dense_grads
    opt = optax.adam(1e-2)
    want = optax.apply_updates(world["jp"], opt.update(g, opt.init(world["jp"]), world["jp"])[0])
    params = diff_params_from_numpy(_np_params(world["jp"]))
    step, init = train.make_train_step(world["tcfg"], DENSE_STEPS, lr=1e-2)
    params, _, loss = step(params, init(params), world["tscene"], _t(target))
    assert float(loss) > 0
    for f in ("density_logits", "albedo_table"):
        w = np.asarray(getattr(want, f))
        assert np.abs(w - np.asarray(getattr(world["jp"], f))).max() > 1e-3
        np.testing.assert_allclose(getattr(params, f).detach().numpy(), w, rtol=0, atol=1e-5)


# ---------------------------------------------------------------- autograd Functions

def test_autograd_functions_match_plain_indexing():
    g = np.random.default_rng(5)
    tab = _t(g.uniform(size=(256, 3)).astype(np.float32)).requires_grad_()
    idx = _t(g.integers(-9, 270, 5000).astype(np.int32))
    ct = _t(g.normal(size=(5000, 3)).astype(np.float32))
    got = torch.autograd.grad((LookupRows.apply(tab, idx) * ct).sum(), tab)[0]
    want = torch.autograd.grad((tab[idx.long().clamp(0, 255)] * ct).sum(), tab)[0]
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(lookup_rows_bwd(ct, idx, 256), lookup_rows_bwd_plain(ct, idx, 256))

    x = _t(g.normal(size=(700, 3)).astype(np.float32)).requires_grad_()
    perm = torch.from_numpy(g.permutation(700).astype(np.int32))
    inv = torch.empty_like(perm)
    inv[perm.long()] = torch.arange(700, dtype=torch.int32)
    ct = _t(g.normal(size=(700, 3)).astype(np.float32))
    got = torch.autograd.grad((tv._PermRows.apply(x, perm, inv) * ct).sum(), x)[0]
    want = torch.autograd.grad((x[perm.long()] * ct).sum(), x)[0]
    torch.testing.assert_close(got, want, rtol=0, atol=0)

    dens = _t(g.uniform(size=600).astype(np.float32)).requires_grad_()
    tab = torch.stack([dens.detach(), _t(g.integers(0, 9, 600).astype(np.float32))], 1)
    idx = _t(g.integers(-5, 610, 4000).astype(np.int32))
    ct = _t(g.normal(size=(4000, 2)).astype(np.float32))
    got = torch.autograd.grad((tv._CellFetch.apply(dens, tab, idx) * ct).sum(), dens)[0]
    want = torch.autograd.grad((torch.stack([dens, tab[:, 1]], 1)[idx.long().clamp(0, 599)]
                                * ct).sum(), dens)[0]
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def test_scene_from_numpy_copies(world):
    """Parameters are updated in place: they must never alias the arrays
    they came from (a numpy view of a JAX CPU array is its buffer)."""
    src = _np_params(world["jp"])
    before = src["albedo_table"].copy()
    params = diff_params_from_numpy(src)
    params.albedo_table += 1.0
    np.testing.assert_array_equal(src["albedo_table"], before)


# ---------------------------------------------------------------- the port's own FD and exactness

@pytest.fixture(scope="module")
def fd_setup(world):
    """Unsaturated params (logits +-1.5, as tests/test_diff.py's FD tests)
    and the span march at n_steps = 32, span_steps = 4, compacted to k."""
    tscene = world["tscene"]
    p = tv.params_from_scene(tscene, occupied_logit=1.5, empty_logit=-1.5)
    target = torch.zeros((H, W, 3))
    kw = dict(n_steps=32, span_steps=4, k=world["k"])

    def loss64(params):
        """The MSE in float64 from the f32 image: the FD quotient then
        resolves changes far below the f32 loss's ulp."""
        with torch.no_grad():
            img = tv.render_diff(params, tscene, world["tcfg"], **kw)
        return float(((img.double() - target.double()) ** 2).mean())

    _, g = tv.value_and_grad(tv.mse_loss)(p, tscene, world["tcfg"], target, **kw)
    return p, g, loss64, loss64(p)


def _bump(p, field, index, eps):
    q = dataclasses.replace(p, **{field: getattr(p, field).clone()})
    getattr(q, field)[index] += eps
    return q


def test_span_march_density_fd(world, fd_setup):
    p, g, loss64, base = fd_setup
    gd = g.density_logits.numpy()
    assert np.isfinite(gd).all() and (np.abs(gd) > 0).any()
    eps = 1e-2
    for fi in np.argsort(np.abs(gd).ravel())[-3:]:
        i = np.unravel_index(fi, gd.shape)
        fd = (loss64(_bump(p, "density_logits", i, eps)) - base) / eps
        ad = float(gd[i])
        assert abs(fd - ad) < 0.1 * max(abs(fd), abs(ad), 1e-4), (fd, ad)
    # empty-space gradients flow through the per-brick mean (dense adjoint)
    grids = world["tscene"].volumes.grids.numpy()
    assert (np.abs(gd[grids == MAT_NONE]) > 0).any()


def test_span_march_albedo_fd(fd_setup):
    p, g, loss64, base = fd_setup
    ga = g.albedo_table.numpy()
    assert np.isfinite(ga).all()
    i = np.unravel_index(np.abs(ga).argmax(), ga.shape)
    eps = 1e-3
    fd = (loss64(_bump(p, "albedo_table", i, eps)) - base) / eps
    assert abs(fd - ga[i]) < 0.05 * max(abs(fd), abs(ga[i])), (fd, ga[i])


@pytest.mark.parametrize("span_steps", [0, 4])
def test_pair_compaction_exact(world, span_steps):
    """The k-compacted march equals the dense one when k >= the most AABBs
    any ray crosses."""
    kw = dict(n_steps=24, span_steps=span_steps)
    dense = tv.render_diff(world["tp"], world["tscene"], world["tcfg"], **kw)
    comp = tv.render_diff(world["tp"], world["tscene"], world["tcfg"], k=world["k"], **kw)
    np.testing.assert_allclose(comp.numpy(), dense.numpy(), rtol=1e-5, atol=1e-6)


def test_train_demo_loss_falls(world):
    target = torch.zeros((H, W, 3))
    _, first = train.train_demo(world["tscene"], world["tcfg"], target, iters=1, n_steps=10,
                                k=world["k"], span_steps=1)
    _, last = train.train_demo(world["tscene"], world["tcfg"], target, iters=4, n_steps=10,
                               k=world["k"], span_steps=1)
    assert last < first
