"""The relaxed march's importance-placed nodes (``importance=P``) against
the JAX package's, on the CPU, and against finite differences of the
port's own loss.

The scene and settings are tests/test_diff.py's importance test
(``test_importance_march_fd_gradients``): the random 66-volume scene of
tests/test_paged.py at seed 7, 24x24, logits +-1.5, the union-span march
at n_steps = 10, span_steps = 1, k = 2 and importance = 8, so that the
union core crosses real gaps between volumes.  Both packages get the very
same arrays (``scene_from_numpy``, ``diff_params_from_numpy``); the JAX
reference runs op by op (``disable_jit``).  At that test's density scale
of 512 the march is opaque within a cell or two and the node placement
moves the image by 3.6e-6 at most; each test runs there and at a density
scale of 8, where it moves the image by 0.67 and the density gradient to
a cosine of 0.64 with the uniform nodes' (measured here).

Tolerances, those of tests/test_torch_diff.py:
* forward images: rtol = atol = 1e-5;
* gradients: density cosine >= 0.9999 and relative L2 <= 1e-2, albedo
  relative L2 <= 1e-2 (the JAX adjoints of the albedo and brick-sigma
  rows round the cotangent to bf16; the port sums in f32);
* the port's FD check: tests/test_diff.py's, |fd - ad| < 0.1 x max(|fd|,
  |ad|, 1e-4) on the 3 largest density gradients, the loss summed in
  float64 from the f32 image.
The bins of ``diff.train`` take importance on their clamped (long-span)
bins only, as scripts/bench_bwd_imp.py applies it; that gradient is held
to the JAX ``mse_loss_active`` gradients of the same bins within the same
rule.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_diff import _cos_rel, _hold_grads, _np_params, _t
from test_torch_paged import _both, _random_specs
from voxtracer.config import RenderConfig as JaxConfig
from voxtracer.diff import volumetric as jv
from voxtracer_torch.config import RenderConfig
from voxtracer_torch.diff import train
from voxtracer_torch.diff import volumetric as tv
from voxtracer_torch.scene.convert import diff_params_from_numpy

torch.set_num_threads(1)

W = H = 24
KW = dict(n_steps=10, span_steps=1, k=2, importance=8)


@pytest.fixture(scope="module")
def world():
    jscene, tscene = _both(_random_specs(seed=7))
    jp = jv.params_from_scene(jscene, occupied_logit=1.5, empty_logit=-1.5)
    return dict(jscene=jscene, tscene=tscene, jp=jp,
                tp=diff_params_from_numpy(_np_params(jp), device="cpu"),
                jcfg=JaxConfig(width=W, height=H, max_bounces=0),
                tcfg=RenderConfig(width=W, height=H, max_bounces=0))


@pytest.mark.parametrize("scale", [512.0, 8.0])
def test_importance_forward_matches_jax(world, scale):
    kw = dict(KW, density_scale=scale)
    with jax.disable_jit():
        want = np.asarray(jv.render_diff(world["jp"], world["jscene"], world["jcfg"],
                                         jax.random.PRNGKey(0), **kw))
    got = tv.render_diff(world["tp"], world["tscene"], world["tcfg"], **kw).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    if scale < 512.0:  # the nodes moved: the uniform core gives another image
        uniform = tv.render_diff(world["tp"], world["tscene"], world["tcfg"],
                                 **dict(kw, importance=0)).numpy()
        assert np.abs(uniform - got).max() > 0.1


@pytest.mark.parametrize("scale", [512.0, 8.0])
def test_importance_gradient_matches_jax(world, scale):
    kw = dict(KW, density_scale=scale)
    target = np.random.default_rng(2).uniform(size=(H, W, 3)).astype(np.float32)
    def jax_loss(params):  # jv.mse_loss with the density scale passed on
        img = jv.render_diff(params, world["jscene"], world["jcfg"], jax.random.PRNGKey(0),
                             **kw)
        return jnp.mean((img - jnp.asarray(target)) ** 2)

    with jax.disable_jit():
        want = jax.grad(jax_loss)(world["jp"])
    _, got = tv.value_and_grad(tv.mse_loss)(world["tp"], world["tscene"], world["tcfg"],
                                            torch.from_numpy(target), **kw)
    assert np.abs(got.density_logits.numpy()).max() > 0
    _hold_grads(got, want)


@pytest.mark.parametrize("scale", [512.0, 8.0])
def test_importance_gradient_fd(world, scale):
    tscene, tcfg, p = world["tscene"], world["tcfg"], world["tp"]
    kw = dict(KW, density_scale=scale)
    target = torch.zeros((H, W, 3))

    def loss64(params):
        with torch.no_grad():
            img = tv.render_diff(params, tscene, tcfg, **kw)
        return float(((img.double() - target.double()) ** 2).mean())

    _, g = tv.value_and_grad(tv.mse_loss)(p, tscene, tcfg, target, **kw)
    gd = g.density_logits.numpy()
    assert np.isfinite(gd).all() and (np.abs(gd) > 0).any()
    base, eps = loss64(p), 1e-2
    for fi in np.argsort(np.abs(gd).ravel())[-3:]:
        i = np.unravel_index(fi, gd.shape)
        q = dataclasses.replace(p, density_logits=p.density_logits.clone())
        q.density_logits[i] += eps
        fd = (loss64(q) - base) / eps
        ad = float(gd[i])
        assert abs(fd - ad) < 0.1 * max(abs(fd), abs(ad), 1e-4), (fd, ad)


def test_binned_importance_matches_jax_bins(world):
    """``train.prepare_bins(importance=8)``: the clamped bin (257 rays at
    10 steps) places its nodes by importance, the short-span bin (80 rays
    at 2) keeps the uniform ones; the summed gradient holds to the JAX
    ``mse_loss_active`` gradients of the same bins with importance on the
    clamped one (scripts/bench_bwd_imp.py's rule).  Logits -4 / -8, where
    the placement turns the density gradient to a cosine of 0.47 with the
    uniform nodes' (measured here)."""
    jscene, tscene = world["jscene"], world["tscene"]
    jp = jv.params_from_scene(jscene, occupied_logit=-4.0, empty_logit=-8.0)
    tp = diff_params_from_numpy(_np_params(jp), device="cpu")
    target = np.random.default_rng(3).uniform(size=(H, W, 3)).astype(np.float32)
    plan = train.prepare_bins(tscene, world["tcfg"], torch.from_numpy(target), tiles=1, k=2,
                              importance=8)
    assert [b.clamp for b in plan.bins] == [False, True]
    _, got = train.binned_grads(tp, tscene, plan)
    want = None
    with jax.disable_jit():
        for b in plan.bins:
            g = jax.grad(jv.mse_loss_active)(
                jp, jscene, world["jcfg"], *(jnp.asarray(x.numpy()) for x in (b.o, b.d, b.bg,
                                                                               b.target)),
                plan.denom, b.steps, k=2, span_steps=1, clamp=b.clamp, n_active=b.n_active,
                spans=tuple(jnp.asarray(s.numpy()) for s in b.spans),
                importance=8 if b.clamp else 0)
            want = g if want is None else jax.tree.map(jnp.add, want, g)
    _hold_grads(got, want)
    uniform = train.binned_grads(tp, tscene, dataclasses.replace(plan, importance=0))[1]
    assert _cos_rel(uniform.density_logits, got.density_logits)[0] < 0.9
