"""The last functions of the JAX package in the port, on the CPU: the
retry helper, the relaxed march's profiling ablations and its
rematerialised dense scan.

* ``utils.retry``: ``with_retries`` in the three cases of
  tests/test_retry.py; ``is_retryable`` agrees with the JAX package's on
  the markers both lists hold and on a ValueError, and refuses every
  sticky CUDA error.
* Each ``_ABLATE_*`` flag, set in both packages with monkeypatch: the
  loss and gradients of ``mse_loss_active`` on the long-span bin of a
  band of tests/test_torch_diff.py's world with half of two volumes'
  bricks emptied (so that occupied spans, leads and tails exist), at
  test_torch_diff.py's bars (loss 1e-5 relative; density cosine 0.9999
  and relative L2 1e-2, albedo relative L2 1e-2; a density gradient the
  flag makes zero is held zero).  The JAX package reads the flags when it
  traces, so its caches are cleared around each case.  It runs under jit,
  except without the clamp: then core samples land on cell faces (as the
  short-span bin's do), where XLA's jit contracts multiply-adds and flips
  cells, so that case runs op by op.
* ``_REMAT``: the dense march's gradient bit-equal with and without it,
  and the step's forward run again in the backward.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_diff import BIN_STEPS, DENSE_STEPS, EDGES, _cos_rel, _hold_grads, _t
from test_torch_render import _flatten, _jax_scene
from voxtracer.config import RenderConfig as JaxConfig
from voxtracer.core.types import MAT_NONE
from voxtracer.diff import volumetric as jv
from voxtracer.render.camera import primary_rays as jax_primary_rays
from voxtracer.render.sky import sample_sky as jax_sample_sky
from voxtracer.scene import presets as jax_presets
from voxtracer.scene.instances import VolumeSpec, build_volumes
from voxtracer.utils import retry as jretry
from voxtracer_torch.config import RenderConfig
from voxtracer_torch.diff import volumetric as tv
from voxtracer_torch.scene.convert import diff_params_from_numpy, scene_from_numpy
from voxtracer_torch.utils import retry

torch.set_num_threads(1)

W, H = 64, 32


# ---------------------------------------------------------------- retry

def _quiet(*a):
    return None


def test_retry_succeeds_after_transient():
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise RuntimeError("[c10d] Connection reset by peer")
        return 42

    assert retry.with_retries(flaky, attempts=3, backoff_s=0.0, log=_quiet) == 42
    assert calls["n"] == 3


def test_non_retryable_raises_immediately():
    calls = {"n": 0}

    def bad():
        calls["n"] += 1
        raise ValueError("shape mismatch")

    with pytest.raises(ValueError):
        retry.with_retries(bad, attempts=3, backoff_s=0.0, log=_quiet)
    assert calls["n"] == 1


def test_exhausted_retries_reraise():
    def always():
        raise RuntimeError("CUDA error: all CUDA-capable devices are busy or unavailable")

    with pytest.raises(RuntimeError):
        retry.with_retries(always, attempts=2, backoff_s=0.0, log=_quiet)


SHARED = [RuntimeError("DEADLINE_EXCEEDED: rendezvous"), RuntimeError("connection reset"),
          ValueError("shape mismatch"), TypeError("bad type")]
STICKY = ["CUDA error: an illegal memory access was encountered",
          "CUDA error: unspecified launch failure",
          "CUDA error: device-side assert triggered",
          "CUDA error: uncorrectable ECC error encountered",
          # a sticky error in a message that also names a retryable one
          "connection reset after CUDA error: an illegal memory access was encountered"]


@pytest.mark.parametrize("exc", SHARED, ids=lambda e: str(e))
def test_is_retryable_agrees_with_jax(exc):
    assert retry.is_retryable(exc) == jretry.is_retryable(exc)


def test_is_retryable_port_markers():
    class DistNetworkError(RuntimeError):
        pass

    for exc in (DistNetworkError("failed to recv"), RuntimeError("Socket Timeout: timed out"),
                RuntimeError("Connection closed by peer"),
                RuntimeError("device is in exclusive-process mode")):
        assert retry.is_retryable(exc), exc
    for msg in STICKY:
        assert not retry.is_retryable(RuntimeError(msg)), msg


# ---------------------------------------------------------------- ablations

FLAGS = ("_ABLATE_ALB_FETCH", "_ABLATE_BSIG_ADJ", "_ABLATE_CELL_FETCH",
         "_ABLATE_CELL_SCATTER", "_ABLATE_SPANS", "_ABLATE_CLAMP")


@pytest.fixture(scope="module")
def sparse():
    """test_torch_diff.py's monu-like world at 64x32 with the upper half of
    volume 0's and volume 1's cells emptied along x and y, and the
    bench's (2,10)@4 bins of its first band of 16 rows: per bin
    (bin_index, n_active, o, d, bg, target, spans), bin 1 the long spans."""
    js = _jax_scene("monu_like", W, H)
    grids = np.array(js.volumes.grids)
    grids[0, 8:] = MAT_NONE
    grids[1, :, 8:] = MAT_NONE
    js = jax_presets._assemble(build_volumes(_volume_specs(grids)), js.materials,
                               lights=js.lights, camera=js.camera)
    jscene = jax.tree.map(jnp.asarray, js)
    jcfg = JaxConfig(width=W, height=H, mode="path", max_bounces=4)
    jp = jv.params_from_scene(jscene)
    rows = H // 2
    px, py = jnp.meshgrid(jnp.arange(W, dtype=jnp.float32),
                          jnp.arange(rows, dtype=jnp.float32))
    o, d = jax_primary_rays(jscene.camera, W, H, px.reshape(-1), py.reshape(-1), None, jnp)
    target = jnp.asarray(np.random.default_rng(0).uniform(size=(rows * W, 3)).astype(np.float32))
    bins = []
    for bi, perm, _, na in jv.span_cells_bins(jscene, jcfg, row0=0, rows=rows, edges=EDGES):
        sel = jnp.asarray(perm[:min(-(-na // 1024) * 1024, o.shape[0])])
        oc, dc = jnp.take(o, sel, axis=0), jnp.take(d, sel, axis=0)
        bins.append(dict(bi=bi, na=na, o=oc, d=dc, target=target[sel],
                         bg=jax_sample_sky(jscene.sky, dc, jcfg.activate_sky, jcfg.sky_fallback),
                         spans=jv.spans_for_rays(jscene, oc, dc)))
    return dict(jscene=jscene, jcfg=jcfg, jp=jp, k=jv.max_aabb_crossings(jscene, jcfg),
                tscene=scene_from_numpy(_flatten(js), device="cpu"),
                tcfg=RenderConfig(width=W, height=H, mode="path", max_bounces=4),
                tp=diff_params_from_numpy({"density_logits": np.asarray(jp.density_logits),
                                           "albedo_table": np.asarray(jp.albedo_table)},
                                          device="cpu"),
                bins=bins, denom=float(rows * W * 3))


def _volume_specs(grids):
    """The VolumeSpecs of _jax_scene("monu_like") with other grids."""
    pos = [(float(i) * 0.75 - 0.75, 0.0, 0.0) for i in range(3)]
    specs = [VolumeSpec(position=p, gridsize=16, grid=grids[i]) for i, p in enumerate(pos)]
    specs.append(VolumeSpec(position=(0.0, -0.51, 0.0), gridsize=1, scale=(8.0, 0.02, 8.0),
                            grid=grids[3, :1, :1, :1]))
    return specs


@pytest.fixture
def fresh_jax():
    """No trace of the JAX package from before or after a flag is set."""
    jax.clear_caches()
    yield
    jax.clear_caches()


@pytest.mark.parametrize("flag", FLAGS)
def test_ablation_matches_jax(sparse, flag, monkeypatch, fresh_jax):
    w = sparse
    b = w["bins"][1]
    kw = dict(k=w["k"], span_steps=1, clamp=b["bi"] > 0, n_active=b["na"])
    steps = BIN_STEPS[b["bi"]]

    def port():
        return tv.value_and_grad(tv.mse_loss_active)(
            w["tp"], w["tscene"], _t(b["o"]), _t(b["d"]), _t(b["bg"]), _t(b["target"]),
            w["denom"], steps, spans=tuple(map(_t, b["spans"])), **kw)

    base_loss, base = port()
    monkeypatch.setattr(jv, flag, True)
    monkeypatch.setattr(tv, flag, True)
    loss, got = port()
    args = (w["jp"], w["jscene"], w["jcfg"], b["o"], b["d"], b["bg"], b["target"], w["denom"],
            steps)
    if flag == "_ABLATE_CLAMP":
        with jax.disable_jit():
            jloss, want = jax.value_and_grad(jv.mse_loss_active)(*args, spans=b["spans"], **kw)
    else:
        jloss, want = jax.value_and_grad(jv.mse_loss_active)(*args, spans=b["spans"], **kw)
    assert abs(float(loss) - float(jloss)) <= 1e-5 * abs(float(jloss)), (float(loss),
                                                                          float(jloss))
    if not np.asarray(want.density_logits).any():
        assert not got.density_logits.any()
        assert _cos_rel(got.albedo_table, want.albedo_table)[1] <= 1e-2
    else:
        _hold_grads(got, want)
    moved = (float(loss) != float(base_loss)
             or not torch.equal(got.density_logits, base.density_logits))
    assert moved, f"{flag} changed nothing"


# ---------------------------------------------------------------- remat

def test_remat_dense_gradient_bit_equal(sparse, monkeypatch):
    target = _t(np.random.default_rng(1).uniform(size=(H, W, 3)).astype(np.float32))
    fetches = {"n": 0}
    kept = tv._cell_fetch

    def counted(*a):
        fetches["n"] += 1
        return kept(*a)

    monkeypatch.setattr(tv, "_cell_fetch", counted)

    def run():
        fetches["n"] = 0
        loss, g = tv.value_and_grad(tv.mse_loss)(sparse["tp"], sparse["tscene"], sparse["tcfg"],
                                                 target, DENSE_STEPS)
        return loss, g, fetches["n"]

    loss0, g0, n0 = run()
    monkeypatch.setattr(tv, "_REMAT", True)
    loss1, g1, n1 = run()
    assert n0 == DENSE_STEPS and n1 == 2 * DENSE_STEPS, (n0, n1)
    assert torch.equal(loss0, loss1)
    for f in ("density_logits", "albedo_table"):
        assert float(getattr(g0, f).abs().max()) > 0
        assert torch.equal(getattr(g0, f), getattr(g1, f)), f


def test_remat_reads_the_environment_at_import():
    assert tv._REMAT is (os.environ.get("VOXTRACER_DIFF_REMAT", "0") == "1")
    code = "import voxtracer_torch.diff.volumetric as v; print(v._REMAT)"
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                         text=True, check=True, env=dict(os.environ, VOXTRACER_DIFF_REMAT="1"))
    assert out.stdout.strip() == "True"
