"""The port's active path replay (voxtracer_torch/diff/replay_active.py)
against the JAX package's, on the CPU; against the port's own capability
replay; and against finite differences of its own loss.

Parity runs on the monu-like scene at 64x32 with 16^3 noise volumes
(``test_torch_render._jax_scene``), carried over with ``scene_from_numpy``,
with the same DiffParams and key.  The JAX package runs op by op
(``jax.disable_jit()``) in its precompute, eager code around the nearest
traversal, and under jit in phase 2: op by op its per-shape compiles take
a minute, and under jit no sample of this scene moved to another cell
(the images agree to 3e-8).  Phase 2 of both packages marches JAX's own
precompute, carried over with ``replay_pre_from_numpy``, so it is held on
the very same frozen segments; the bins march (2, 6) steps and the
primary span (2, 8), fewer than the bench's (2, 10) and (4, 16).

Tolerances, each with its reason:
* the precompute: the lane selection and order (``sel``, ``perm``),
  ``n_hit``, ``n_c``, ``media_lanes``, every march's segment count, bins
  and delivery map, and the frozen hit records equal.  Each segment's
  t_lo, t_hi, s0 and s1 within 1e-6 relative, and its origin and
  direction too, on the lanes whose bounce draws equal jax.random's bit
  for bit; ``threefry_normal`` draws about 14% of the normals an ulp or
  two away, which moves their bounce segments by as much (2.5e-6 in s1
  when this was written) but moved no frozen hit (0 lanes of 2,048, as
  the equal hit records say).
* phase 2: images within rtol = atol = 1e-5; gradients as
  tests/test_torch_diff.py holds them (density cosine >= 0.9999 and
  relative L2 <= 1e-2, albedo relative L2 <= 1e-2: the JAX adjoint of the
  albedo and brick-sigma rows rounds the cotangent to bf16).
* the brick-granular lead and tail, on a scene built for them (the camera
  inside a grid whose near three quarters are empty bricks): the image
  and gradients of phase 2 on JAX's own precompute at the tolerances
  above; the lead and tail must move the image and give every cell of the
  empty bricks a density gradient, which reaches them through the
  per-brick mean sigma alone.
* the active estimator against the capability one on the non-media hit
  lanes, and the FD check of the active loss: the JAX package's own bars
  (tests/test_replay_active.py: mean < 0.03, 95th percentile < 0.15;
  FD within 5%).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_render import _flatten, _jax_scene
from voxtracer.config import RenderConfig as JaxConfig
from voxtracer.diff import replay_active as jra
from voxtracer.diff.volumetric import params_from_scene as jax_params_from_scene
from voxtracer.render.camera import make_camera as jax_camera
from voxtracer.scene import presets as jax_presets
from voxtracer.scene.instances import VolumeSpec, build_volumes
from voxtracer.scene.lights import make_lights
from voxtracer.scene.materials import default_materials
from voxtracer_torch.config import RenderConfig
from voxtracer_torch.core.rng import fold_in, make_key, threefry_normal
from voxtracer_torch.diff import path_replay as tpr
from voxtracer_torch.diff import replay_active as tra
from voxtracer_torch.diff.volumetric import params_from_scene
from voxtracer_torch.scene import presets
from voxtracer_torch.scene.convert import (diff_params_from_numpy, replay_pre_from_numpy,
                                           scene_from_numpy)

torch.set_num_threads(1)

W, H = 64, 32
BINS = dict(steps=(2, 6), tau0_steps=(2, 8))
SEG = ("o", "d", "t_lo", "t_hi", "s0", "s1")


def _cos_rel(got, want):
    a = np.asarray(got, np.float64).ravel()
    b = np.asarray(want, np.float64).ravel()
    return (float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b))),
            float(np.linalg.norm(a - b) / np.linalg.norm(b)))


@pytest.fixture(scope="module")
def world():
    js = _jax_scene("monu_like", W, H)
    jscene = jax.tree.map(jnp.asarray, js)
    jcfg = JaxConfig(width=W, height=H, mode="path", max_bounces=4)
    jp = jax_params_from_scene(jscene)
    with jax.disable_jit():
        jpre = jra.replay_precompute(jscene, jcfg, jax.random.PRNGKey(0), **BINS)
    return dict(jscene=jscene, jcfg=jcfg, jp=jp, jpre=jpre,
                tscene=scene_from_numpy(_flatten(js), device="cpu"),
                tcfg=RenderConfig(width=W, height=H, mode="path", max_bounces=4),
                tp=diff_params_from_numpy({"density_logits": np.asarray(jp.density_logits),
                                           "albedo_table": np.asarray(jp.albedo_table)},
                                          device="cpu"))


def _marches(pre):
    """(name, march) of every march of a precompute, lights included."""
    out = list(pre["marches"].items())
    for name, lst in pre["light_marches"].items():
        out += [(f"{name}[{i}]", m) for i, m in enumerate(lst)]
    return out


def test_replay_precompute_matches_jax(world):
    jpre = world["jpre"]
    tpre = tra.replay_precompute(world["tscene"], world["tcfg"], make_key(0), **BINS)
    for k in ("n", "n_c", "n_hit", "media_lanes"):
        assert tpre[k] == jpre[k], k
    assert 0 < tpre["n_hit"] < tpre["n"]
    for k in ("sel", "perm", "hit", "m0", "bounce", "bounce2", "shade0", "m1", "hit1",
              "m2", "hit2"):
        np.testing.assert_array_equal(tpre[k].numpy(), np.asarray(jpre[k]), err_msg=k)
    for k in ("sky1", "sky2", "bg"):
        np.testing.assert_allclose(tpre[k].numpy(), np.asarray(jpre[k]), rtol=1e-6, atol=1e-6)
    # the lanes whose bounce draws differ from jax.random's by an ulp or two
    n, sel = jpre["n"], np.asarray(jpre["sel"])
    with jax.disable_jit():
        ulp = np.zeros(jpre["n_c"], bool)
        for salt in (2, 4):
            want = np.asarray(jax.random.normal(jax.random.fold_in(jax.random.PRNGKey(0), salt),
                                                (n, 3)))[sel]
            got = threefry_normal(fold_in(make_key(0), salt), (n, 3), "cpu").numpy()[sel]
            ulp |= (want != got).any(-1)
    for (name, jm), (_, tm) in zip(_marches(jpre), _marches(tpre)):
        assert tm["m"] == jm["m"] and tm["n_lanes"] == jm["n_lanes"], name
        if not jm["m"]:
            continue
        assert tm["bins"] == [tuple(int(v) for v in b) for b in jm["bins"]], name
        inv_map = np.asarray(jm["inv_map"])
        np.testing.assert_array_equal(tm["inv_map"].numpy(), inv_map, err_msg=name)
        # segment order -> lane: the segments of lanes with equal draws
        lane = np.full(jm["m"], -1)
        hit = inv_map < jm["m"]
        lane[inv_map[hit]] = np.nonzero(hit)[0]
        same = ~ulp[lane] if name not in ("tau0", "e0[0]") else np.ones(jm["m"], bool)
        for k in SEG:
            np.testing.assert_allclose(tm[k].numpy()[same], np.asarray(jm[k])[same],
                                       rtol=1e-6, atol=1e-7, err_msg=f"{name}.{k}")
    for name in jpre["light_rads"]:
        for (jr, jg), (tr_, tg) in zip(jpre["light_rads"][name], tpre["light_rads"][name]):
            np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
            np.testing.assert_allclose(tr_.numpy(), np.asarray(jr), rtol=1e-5, atol=1e-6)


def _phase2_against_jax(w, jpre, width, height):
    """Phase 2 of both packages on one precompute in JAX's form -> (its
    port copy, the port's image and DiffParams gradient, JAX's gradient),
    the image and gradients held at the tolerances of the module
    docstring."""
    pre = replay_pre_from_numpy(jax.tree.map(np.asarray, jpre), device="cpu")
    target = np.random.default_rng(2).uniform(size=(jpre["n_c"], 3)).astype(np.float32)
    denom = float(width * height * 3)
    spec, arrs = jra.split_pre(jpre)

    def img_and_grad(p, arrs_):
        img, vjp = jax.vjp(lambda q: jra.render_replay_active(q, w["jscene"], w["jcfg"],
                                                              spec, arrs_), p)
        live = (jnp.arange(jpre["n_c"]) < jpre["n_hit"])[:, None]
        return img, vjp(jnp.where(live, 2.0 * (img - jnp.asarray(target)), 0.0) / denom)[0]

    img, g = jax.jit(img_and_grad)(w["jp"], arrs)
    got = tra.render_replay_active(w["tp"], w["tscene"], w["tcfg"], *tra.split_pre(pre)).detach()
    np.testing.assert_allclose(got.numpy(), np.asarray(img), rtol=1e-5, atol=1e-5)
    loss = tra.mse_loss_replay_active(w["tp"], w["tscene"], w["tcfg"], *tra.split_pre(pre),
                                      torch.from_numpy(target), denom)
    live = np.arange(jpre["n_c"]) < jpre["n_hit"]
    jloss = float((((np.asarray(img) - target) ** 2).sum(-1) * live).sum()) / denom
    assert abs(float(loss) - jloss) <= 1e-5 * jloss, (float(loss), jloss)
    grad_fn, loss_fn = tra.make_replay_grad_fn(w["tscene"], w["tcfg"], pre,
                                               torch.from_numpy(target), denom)
    tg = grad_fn(w["tp"])
    cos, rel = _cos_rel(tg.density_logits.numpy(), g.density_logits)
    assert cos >= 0.9999 and rel <= 1e-2, (cos, rel)
    _, rel_a = _cos_rel(tg.albedo_table.numpy(), g.albedo_table)
    assert rel_a <= 1e-2, rel_a
    assert np.isfinite(float(loss_fn(w["tp"])))
    return pre, got, tg, g


def test_split_pre_matches_jax(world):
    """The port's split of JAX's own precompute: the JAX split's keys at
    every level, its spec values, and in arrs the tensors pre holds."""
    jspec, jarrs = jra.split_pre(world["jpre"])
    pre = replay_pre_from_numpy(jax.tree.map(np.asarray, world["jpre"]), device="cpu")
    spec, arrs = tra.split_pre(pre)

    def keys(t):
        if isinstance(t, dict):
            return {k: keys(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return [keys(v) for v in t]
        return None

    assert keys(spec) == keys(jspec) and keys(arrs) == keys(jarrs)

    def ints(t):
        if isinstance(t, dict):
            return {k: ints(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return [ints(v) for v in t]
        return int(t)

    assert ints(spec) == ints(jspec)
    assert arrs["lanes"]["bg"] is pre["bg"] and arrs["lr"] is pre["light_rads"]
    for nm, m in pre["marches"].items():
        for k, v in arrs["marches"][nm].items():
            assert v is m[k], (nm, k)
    for nm, lst in pre["light_marches"].items():
        for m, a in zip(lst, arrs["lm"][nm]):
            assert all(a[k] is m[k] for k in a), nm


def test_render_replay_active_and_gradient_match_jax(world):
    """Phase 2 of both packages on JAX's own precompute."""
    _phase2_against_jax(world, world["jpre"], W, H)


def _jax_tree(tree):
    """A port precompute as the JAX package's phase 2 takes it: tensors to
    JAX arrays, the counts, bins and nesting as they are."""
    if isinstance(tree, dict):
        return {k: _jax_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_jax_tree(v) for v in tree)
    return jnp.asarray(tree.numpy()) if isinstance(tree, torch.Tensor) else tree


def test_brick_lead_and_tail_match_jax():
    """The lead and tail of each segment, marched at the per-brick mean
    sigma (``_bsig_rows`` on ``_brick_mean_sigma``): volume 1 is 32^3,
    its last brick slab (z cells 24-31) solid, the camera and the light
    inside its empty bricks, at unsaturated logits; volume 0, an 8^3 cube
    out of view, puts volume 1's bricks at an offset in the brick table.
    Every primary span, shadow segment and bounce leg then crosses empty
    bricks of volume 1 outside the occupied span.  Phase 2 of both packages
    marches the port's precompute (test_replay_precompute_matches_jax holds
    the precompute)."""
    size, g = 16, 32
    grid = np.full((g, g, g), 255, np.uint8)
    grid[:, :, 24:] = 7
    js = jax_presets._assemble(
        build_volumes([VolumeSpec(position=(-1.0, 0.0, 0.0), gridsize=8,
                                  grid=np.full((8, 8, 8), 7, np.uint8)),
                       VolumeSpec(position=(0.0, 0.0, 0.0), gridsize=g, grid=grid)]),
        default_materials(), lights=make_lights(point=((0.5, 0.8, 0.3, 2.0, 2.0, 2.0),)),
        camera=jax_camera(pos=(0.5, 0.45, 0.05), target=(0.5, 0.5, 1.0), aspect=1.0))
    jscene = jax.tree.map(jnp.asarray, js)
    jp = jax_params_from_scene(jscene, occupied_logit=0.5, empty_logit=-4.0)
    w = dict(jscene=jscene, jcfg=JaxConfig(width=size, height=size, mode="path", max_bounces=4),
             jp=jp, tscene=scene_from_numpy(_flatten(js), device="cpu"),
             tcfg=RenderConfig(width=size, height=size, mode="path", max_bounces=4),
             tp=diff_params_from_numpy({"density_logits": np.asarray(jp.density_logits),
                                        "albedo_table": np.asarray(jp.albedo_table)},
                                       device="cpu"))
    tpre = tra.replay_precompute(w["tscene"], w["tcfg"], make_key(0), **BINS)
    assert tpre["n_hit"] > size * size // 2
    pre, img, tg, jg = _phase2_against_jax(w, _jax_tree(tpre), size, size)
    # the lead and tail move the image: the same precompute without them
    bare = dict(pre, marches={k: dict(m, lead_steps=0) for k, m in pre["marches"].items()},
                light_marches={k: [dict(m, lead_steps=0) for m in ms]
                               for k, ms in pre["light_marches"].items()})
    with torch.no_grad():
        img0 = tra.render_replay_active(w["tp"], w["tscene"], w["tcfg"], *tra.split_pre(bare))
    lead_img = (img - img0).abs().amax(-1)
    # the empty bricks' cells take their gradient through the brick sigma
    # alone: no core sample lies outside the occupied slab
    lead = tg.density_logits[1, :, :, :24].numpy()
    want = np.asarray(jg.density_logits)[1, :, :, :24]
    print(f"lead/tail: image max {float(lead_img.max()):.4g}, lanes moved "
          f"{int((lead_img > 1e-4).sum())} of {pre['n_c']}; empty-brick cells with a "
          f"gradient {int((lead != 0).sum())} of {lead.size}")
    assert float(lead_img.max()) > 1e-2
    assert (lead != 0).mean() > 0.5 and ((lead != 0) == (want != 0)).all()
    cos, rel = _cos_rel(lead, want)
    assert cos >= 0.9999 and rel <= 1e-2, (cos, rel)


@pytest.fixture(scope="module")
def monu():
    """tests/test_replay_active.py's setup with the port's asset-free scene:
    64x36, one 64^3 model (monu_path's which=(1,)) and the floor, 2
    bounces, the bench's bins.  With all three noise models the two
    estimators part by more (mean 0.032, 95th percentile 0.23 when this was
    written): the noise grids' thin features are where the capability
    replay's 48 uniform primary samples and the active replay's span bins
    integrate differently."""
    scene, cfg = presets.monu_like_path(64, 36, gridsize=64, bounces=2, seeds=(1,))
    params = params_from_scene(scene)
    return scene, cfg, params, make_key(0), tra.replay_precompute(scene, cfg, make_key(0))


def test_active_matches_the_capability_estimator(monu):
    """The active path replays the same frozen paths (the same draws) with
    span-clamped quadrature: images agree on the non-media hit lanes to
    quadrature tolerance."""
    scene, cfg, params, key, pre = monu
    img_a = tra.render_replay_active(params, scene, cfg, *tra.split_pre(pre)).detach().numpy()
    with torch.no_grad():
        ref = tpr.render_diff_replay(params, scene, cfg, key, n_steps=48, seg_steps=24).numpy()
    d = np.abs(img_a - ref.reshape(-1, 3)[pre["sel"].numpy()])[pre["hit"].numpy()]
    assert np.isfinite(img_a).all() and d.size > 0
    assert d.mean() < 0.03, d.mean()
    assert np.percentile(d, 95) < 0.15, np.percentile(d, 95)


def test_active_grad_fd(monu):
    """Autodiff against central differences of the active loss at the
    bench's settings, on the strongest density cell."""
    scene, cfg, params, key, pre = monu
    denom = float(cfg.width * cfg.height * 3)
    grad_fn, loss_fn = tra.make_replay_grad_fn(scene, cfg, pre, torch.zeros(pre["n_c"], 3),
                                               denom)
    gd = grad_fn(params).density_logits
    assert bool(torch.isfinite(gd).all()) and float(gd.abs().max()) > 0.0
    cell = np.unravel_index(int(gd.abs().argmax()), gd.shape)
    eps = 2e-2
    vals = []
    for s in (1.0, -1.0):
        dl = params.density_logits.clone()
        dl[cell] += s * eps
        vals.append(float(loss_fn(dataclasses.replace(params, density_logits=dl))))
    fd = (vals[0] - vals[1]) / (2 * eps)
    ad = float(gd[cell])
    assert abs(fd - ad) < 0.05 * max(abs(fd), abs(ad)) + 1e-9, (fd, ad)
