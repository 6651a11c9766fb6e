"""The port's capability path replay (voxtracer_torch/diff/path_replay.py)
against the JAX package's, on the CPU, and against finite differences of
its own loss.

Both packages get the very same arrays: the four scenes of
tests/test_replay.py (shadow, mirror, glass, smoke; built with the JAX
package's builders and carried over with ``scene_from_numpy``) at 16^2
with 8 march steps, and the same DiffParams.  The JAX references run op by
op (``jax.disable_jit()``): under jit XLA contracts multiply-adds and moves
hits and midpoint samples across cell faces of these axis-aligned scenes.

Tolerances, each with its reason:
* ``_far_bound``, ``_segment_tau``, ``_segment_soft_length``: within 1e-6
  relative (NaN where JAX gives NaN); the port rounds the object-space
  rays as XLA's dot does (a chain of fused multiply-adds).
* images: rtol = atol = 1e-5 on every lane whose bounce draws equal the
  JAX package's bit for bit.  ``core.rng.threefry_normal`` writes out
  XLA's erf_inv polynomial to within 2 ulps (13-16% of the lanes here
  draw a normal an ulp or two away), and one ulp in a bounce direction
  can move a replayed hit to another cell.  So a pixel off by more may
  only be such a lane, and at most 2% of the pixels: 0 of the 256 were,
  in each scene, when this was written.
* gradients: density cosine >= 0.9999 and relative L2 <= 1e-2, albedo
  relative L2 <= 1e-2 (tests/test_torch_diff.py's tolerances: the JAX
  adjoint of the albedo rows rounds the cotangent to bf16).
* bands (port only): a band of rows renders its rows of the full frame
  within 1e-6 where its draws are the full frame's.  A band draws its
  bounce samples at its own ray count, as the JAX package's does, so the
  first band's draws are a prefix of the frame's and equal on every lane;
  a later band's are held on the lanes that draw nothing (glass
  primaries, whose chain is deterministic under a point light, and
  misses).
* finite differences (port only, the JAX tests' own bars and settings):
  density through a shadow and through smoke within 20%, albedo through a
  mirror within 15%, albedo behind glass within 10%.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_replay import _glass_scene, _mirror_scene, _shadow_scene, _smoke_scene
from test_torch_render import _flatten
from voxtracer.diff import path_replay as jpr
from voxtracer.diff.volumetric import params_from_scene as jax_params_from_scene
from voxtracer_torch.config import RenderConfig
from voxtracer_torch.core.rng import fold_in, make_key, threefry_normal
from voxtracer_torch.core.types import GLASS
from voxtracer_torch.diff import path_replay as tpr
from voxtracer_torch.diff import train
from voxtracer_torch.diff.volumetric import params_from_scene, softplus, value_and_grad
from voxtracer_torch.render import integrator
from voxtracer_torch.render.camera import primary_rays
from voxtracer_torch.scene.convert import diff_params_from_numpy, scene_from_numpy

torch.set_num_threads(1)

SIZE = 16
KW = dict(n_steps=8, seg_steps=8)
# the mirror wall is 0.2 thick: 8 primary samples over the 3.6 of the
# primary span step over it (no density gradient at all), 24 do not
STEPS = {"mirror": dict(n_steps=24, seg_steps=8)}
SCENES = {"shadow": _shadow_scene, "mirror": _mirror_scene, "glass": _glass_scene,
          "smoke": _smoke_scene}
# occupied-cell logits: unsaturated, so every scene has density gradients
LOGIT = {"shadow": 0.5, "mirror": 0.5, "glass": 0.5, "smoke": 0.3}


def _port_cfg(jcfg):
    return RenderConfig(**{f.name: getattr(jcfg, f.name)
                           for f in dataclasses.fields(RenderConfig) if hasattr(jcfg, f.name)})


def _np_params(p):
    return {f.name: np.asarray(getattr(p, f.name)) for f in dataclasses.fields(p)}


def _cos_rel(got, want):
    a = np.asarray(got, np.float64).ravel()
    b = np.asarray(want, np.float64).ravel()
    return (float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b))),
            float(np.linalg.norm(a - b) / np.linalg.norm(b)))


def _both(name, size=SIZE, occupied=None):
    js, jcfg = SCENES[name](size, size)
    occupied = LOGIT[name] if occupied is None else occupied
    jscene = jax.tree.map(jnp.asarray, js)
    jp = jax_params_from_scene(jscene, occupied_logit=occupied, empty_logit=-6.0)
    return dict(jscene=jscene, jcfg=jcfg, jp=jp,
                tscene=scene_from_numpy(_flatten(js), device="cpu"), tcfg=_port_cfg(jcfg),
                tp=diff_params_from_numpy(_np_params(jp), device="cpu"))


@pytest.fixture(scope="module", params=list(SCENES))
def replayed(request):
    """One scene rendered and differentiated by both packages: the JAX
    image and mse_loss_replay gradient from one op-by-op vjp."""
    w = _both(request.param)
    n = SIZE * SIZE
    target = np.random.default_rng(7).uniform(size=(SIZE, SIZE, 3)).astype(np.float32)
    key = jax.random.PRNGKey(0)
    with jax.disable_jit():
        img, vjp = jax.vjp(lambda p: jpr.render_diff_replay(p, w["jscene"], w["jcfg"], key,
                                                            **STEPS.get(request.param, KW)),
                           w["jp"])
        (g,) = vjp(2.0 * (img - jnp.asarray(target)) / img.size)
        # lanes whose bounce draws (salts 2 and 4) differ from jax.random's
        ulp = np.zeros(n, bool)
        for salt in (2, 4):
            want = np.asarray(jax.random.normal(jax.random.fold_in(key, salt), (n, 3)))
            got = threefry_normal(fold_in(make_key(0), salt), (n, 3), "cpu").numpy()
            ulp |= (want != got).any(-1)
    return dict(w, name=request.param, img=np.asarray(img), grads=g, target=target,
                ulp_lanes=ulp.reshape(SIZE, SIZE))


def test_segment_marches_match_jax():
    """``_far_bound``, ``_segment_tau`` and ``_segment_soft_length`` on rays
    into the smoke scene's volumes, axis-parallel ones among them."""
    w = _both("smoke")
    rng = np.random.default_rng(3)
    n = 512
    o = rng.uniform(-0.5, 1.5, (n, 3)).astype(np.float32)
    o[:, 2] = -1.0
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[:, 2] = np.abs(d[:, 2]) + 0.5
    d[:64, :2] = 0.0                       # along z: divides by zero in x and y
    d[64:96, 0] = 0.0
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t_lo = rng.uniform(0.0, 1.0, n).astype(np.float32)
    t_hi = t_lo + rng.uniform(0.0, 3.0, n).astype(np.float32)
    active = rng.uniform(size=n) < 0.8
    jp, tp = w["jp"], w["tp"]
    j_dens = jax.nn.softplus(jp.density_logits).reshape(-1) * 64.0
    j_tab = jnp.stack([j_dens, w["jscene"].volumes.grids.reshape(-1).astype(jnp.float32)], 1)
    t_dens = softplus(tp.density_logits).reshape(-1) * 64.0
    t_tab = torch.stack([t_dens, w["tscene"].volumes.grids.reshape(-1).float()], 1)
    ja = [jnp.asarray(x) for x in (o, d, t_lo, t_hi, active)]
    ta = [torch.from_numpy(x) for x in (o, d, t_lo, t_hi, active)]
    with jax.disable_jit():
        far = np.asarray(jpr._far_bound(w["jscene"], ja[0], ja[1]))
        tau = np.asarray(jpr._segment_tau(j_dens, j_tab, w["jscene"], *ja[:4], 12, ja[4]))
        soft = np.asarray(jpr._segment_soft_length(j_dens, j_tab, w["jscene"], *ja[:4], 12,
                                                   ja[4], 64.0))
    got_far = tpr._far_bound(w["tscene"], ta[0], ta[1]).numpy()
    np.testing.assert_allclose(got_far, far, rtol=1e-6, atol=0, equal_nan=True)
    assert (far > 0).sum() > n // 2
    got_tau = tpr._segment_tau(t_dens, t_tab, w["tscene"], *ta[:4], 12, ta[4]).numpy()
    got_soft = tpr._segment_soft_length(t_dens, t_tab, w["tscene"], *ta[:4], 12, ta[4],
                                        64.0).numpy()
    np.testing.assert_allclose(got_tau, tau, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got_soft, soft, rtol=1e-6, atol=1e-6)
    assert (tau > 0).sum() > n // 4 and (soft > 0).sum() > n // 4


def test_render_diff_replay_matches_jax(replayed):
    got = tpr.render_diff_replay(replayed["tp"], replayed["tscene"], replayed["tcfg"],
                                 make_key(0), **STEPS.get(replayed["name"], KW)).numpy()
    want = replayed["img"]
    ulp = replayed["ulp_lanes"]
    assert got.shape == want.shape and np.isfinite(got).all()
    off = (np.abs(got - want) > 1e-5 + 1e-5 * np.abs(want)).any(-1)
    assert not (off & ~ulp).any(), f"{(off & ~ulp).sum()} pixels off with equal draws"
    assert off.mean() <= 0.02, f"{off.sum()} pixels off on lanes of other draws"
    assert got.std() > 1e-3  # the scene is not blank


def test_replay_gradients_match_jax_grad(replayed):
    loss, g = value_and_grad(tpr.mse_loss_replay)(
        replayed["tp"], replayed["tscene"], replayed["tcfg"], torch.from_numpy(replayed["target"]),
        make_key(0), **STEPS.get(replayed["name"], KW))
    assert np.isfinite(float(loss))
    cos, rel = _cos_rel(g.density_logits.numpy(), replayed["grads"].density_logits)
    assert cos >= 0.9999 and rel <= 1e-2, (cos, rel)
    _, rel_a = _cos_rel(g.albedo_table.numpy(), replayed["grads"].albedo_table)
    assert rel_a <= 1e-2, rel_a


def test_render_diff_replay_bands():
    """``rows``/``row0`` banding on the glass scene: two bands of 8 rows
    against the 16-row frame (module docstring)."""
    w = _both("glass")
    args = (w["tp"], w["tscene"], w["tcfg"], make_key(0))
    with torch.no_grad():
        full = tpr.render_diff_replay(*args, **KW).numpy()
        bands = [tpr.render_diff_replay(*args, **KW, row0=r, rows=8).numpy() for r in (0, 8)]
    assert bands[0].shape == (8, SIZE, 3)
    np.testing.assert_allclose(bands[0], full[:8], rtol=1e-6, atol=1e-6)
    # the lanes of the second band that draw nothing
    y, x = torch.meshgrid(torch.arange(8.0, SIZE), torch.arange(float(SIZE)), indexing="ij")
    o, d = primary_rays(w["tscene"].camera, SIZE, SIZE, x.reshape(-1), y.reshape(-1))
    rec = integrator.find_nearest_world(w["tscene"], o, d, torch.ones(o.shape[0], dtype=bool))
    still = (~rec["hit"] | (rec["mat"] == GLASS)).reshape(8, SIZE).numpy()
    assert still.sum() >= 16 and (rec["mat"] == GLASS).sum() >= 8
    np.testing.assert_allclose(bands[1][still], full[8:][still], rtol=1e-6, atol=1e-6)
    # and the band is not the first rows again
    assert np.abs(bands[1][still] - full[:8][still]).max() > 1e-3


# -- finite differences of the port's own loss, one per FD test of the JAX
# package (tests/test_replay.py), at its sizes and step counts

FD_KW = dict(n_steps=32, seg_steps=32)


def _sum_loss(w, key, target):
    def loss(p):
        img = tpr.render_diff_replay(p, w["tscene"], w["tcfg"], key, **FD_KW)
        return ((img - target) ** 2).sum()
    return loss


def _fd(loss, params, field, index, eps):
    vals = []
    for s in (1.0, -1.0):
        x = getattr(params, field).clone()
        x[index] += s * eps
        with torch.no_grad():
            vals.append(float(loss(dataclasses.replace(params, **{field: x}))))
    return (vals[0] - vals[1]) / (2 * eps)


@pytest.mark.parametrize("name,vol", [("shadow", 1), ("smoke", 0)])
def test_density_fd(name, vol):
    """Density through a shadow segment (a blocker no camera ray sees) and
    through the smoke chain's absorption exponent."""
    w = _both(name, 24)
    loss = _sum_loss(w, make_key(0 if name == "shadow" else 4), torch.zeros(24, 24, 3))
    _, g = value_and_grad(loss)(w["tp"])
    gd = g.density_logits[vol].numpy()
    assert np.isfinite(gd).all() and np.abs(gd).max() > 0.0
    flat = np.abs(gd).reshape(-1)
    cand = [fi for fi in np.argsort(flat)[-3:] if flat[fi] > 0.2 * flat.max()]
    assert cand
    for fi in cand:
        cell = (vol, *np.unravel_index(fi, gd.shape))
        fd = _fd(loss, w["tp"], "density_logits", cell, 2e-2)
        ad = float(g.density_logits[cell])
        assert abs(fd - ad) < 0.2 * max(abs(fd), abs(ad)) + 1e-5, (fd, ad)


def test_albedo_fd_through_reflection():
    """The albedo of a box seen only in a mirror (material 1)."""
    w = _both("mirror", 24, occupied=6.0)
    loss = _sum_loss(w, make_key(1), torch.zeros(24, 24, 3))
    _, g = value_and_grad(loss)(w["tp"])
    ga = g.albedo_table[1].numpy()
    assert np.isfinite(ga).all() and np.abs(ga).max() > 0.0
    ci = int(np.abs(ga).argmax())
    fd = _fd(loss, w["tp"], "albedo_table", (1, ci), 5e-2)
    assert abs(fd - ga[ci]) < 0.15 * max(abs(fd), abs(ga[ci])) + 1e-6, (fd, ga[ci])


def test_glass_chain_albedo_fd():
    """The albedo of a wall seen only through a glass slab: the gradient
    runs through the replayed dielectric chain (the exit march)."""
    w = _both("glass", 24, occupied=6.0)
    true_alb = w["tp"].albedo_table.clone()
    true_alb[2] = torch.tensor([0.9, 0.2, 0.1])
    with torch.no_grad():
        target = tpr.render_diff_replay(dataclasses.replace(w["tp"], albedo_table=true_alb),
                                        w["tscene"], w["tcfg"], make_key(0), **FD_KW)
    loss = _sum_loss(w, make_key(0), target)
    _, g = value_and_grad(loss)(w["tp"])
    ga = g.albedo_table.numpy()
    assert np.isfinite(ga).all() and np.abs(ga[2]).max() > 1e-4
    fd = _fd(loss, w["tp"], "albedo_table", (2, 0), 1e-2)
    assert abs(fd - ga[2, 0]) / max(abs(fd), 1e-6) < 0.1, (fd, ga[2, 0])


def test_smoke_density_recovery_loss_falls():
    """A short inverse-rendering run with the port's Adam: recover the
    smoke's density from a target that differs only in how much the medium
    absorbs; the loss falls."""
    w = _both("smoke", SIZE)
    kw = dict(n_steps=16, seg_steps=16, density_scale=8.0)
    key = make_key(5)
    p_true = params_from_scene(w["tscene"], occupied_logit=2.0, empty_logit=-3.0)
    with torch.no_grad():
        target = tpr.render_diff_replay(p_true, w["tscene"], w["tcfg"], key, **kw)
    dl = p_true.density_logits.clone()
    dl[0] = -2.0  # thin smoke; the target's is dense
    params = dataclasses.replace(p_true, density_logits=dl)
    _, init = train.make_train_step(w["tcfg"], lr=0.25)
    opt = init(params)
    losses = []
    for _ in range(8):
        opt.zero_grad(set_to_none=True)
        loss = tpr.mse_loss_replay(params, w["tscene"], w["tcfg"], target, key, **kw)
        loss.backward()
        params.albedo_table.grad = None  # density only, as the JAX test
        opt.step()
        losses.append(float(loss))
    assert losses[0] > 1e-7 and losses[-1] < 0.5 * losses[0], losses
