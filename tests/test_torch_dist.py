"""The port's ray-sharded rendering and sharded training over
torch.distributed, on CPU ranks: gloo, processes spawned fresh
(``dist.multihost.spawn``, a FileStore in a temporary directory, no
port), each spawn with a timeout of its own.

* The lane window of the random streams: without one, the streams are
  the JAX package's (today's) bit for bit; a windowed draw equals the
  slice of the global draw; a path traced on a slice of the rays at their
  lanes equals the slice of the whole frame's, bit for bit.
* ``render_sharded`` on 2 and 4 ranks equals the 1-rank frame bit for
  bit, in whitted mode (glassbox 16x8, depth 2) and path mode (monu_like
  16x8, 2 bounces; 128 pixels, so no pad lane), and in the two frames
  that share the global wavefront: the path frame with
  ``bounce_reorder="always"`` (the state gathered at each reorder; on 4
  ranks rank 0's lanes all miss at bounce 0, so the bounce loop must stop
  on every rank together) and glassbox whitted with random light choice,
  two point lights and an area light (light samples drawn at the global
  queue slot).  The 1-rank frames hold to the JAX ``render_sharded`` on a
  1-device mesh run op by op (``disable_jit``) within the port's
  tolerances: tests/test_torch_render.py's path rule (mean absolute
  difference <= 1e-4, at most 1% of pixels off by more than 1e-3) and
  tests/test_torch_whitted.py's queue rule (at most 1% of pixels off by
  more than 1e-4, median difference <= 1e-6).  An uneven 13x11 path
  frame (143 pixels padded to 144) has the right shape and is finite; a
  window of lanes of a reordering wavefront without the other ranks is
  refused.
* The render options that act on the global wavefront, on 2 and 4 ranks
  bit for bit the 1-rank frame: the compacted path frame
  (``compact_chunks = 3`` on monu_like 16x9, 144 rays: chunks of 48
  lanes, which straddle the ranks' windows of 72 and 36), the reordered
  frame in live-prefix chunks (``reorder_compact_chunks = 3``) and the
  random-light whitted frame with ``whitted_sort_batch``.
* A (2, 2) ``train_demo`` on 4 ranks (glassbox 16x16 in path mode, 16
  march steps): the loss within 1e-5 relative and each gradient within
  relative L2 1e-4 of the 1-rank step (PERF.md's gradient gate), and the
  loss falls over 5 steps (tests/test_dist.py's case); the
  ``shard_params`` layout.  The 1-rank gradient equals the port's
  unsharded ``value_and_grad(mse_loss)`` within the same gate, and the
  1-rank ``train_demo`` of 1 and 5 steps holds to the JAX ``train_demo``
  on a (1, 1) mesh run op by op (losses and params, tolerances at the
  test).
* ``multihost``: the JAX ``gather_image`` loses rows when the last band
  is moved up (height 10 over 3 processes); the port's assembly keeps
  them.

The rank functions below import no JAX: spawned ranks import this module.
"""

import dataclasses

import numpy as np
import pytest
import torch

from voxtracer_torch.core.rng import (fold_in, hash_bits, hash_normal, make_key,
                                      threefry_bits, threefry_uniform)
from voxtracer_torch.diff.volumetric import mse_loss, params_from_scene, value_and_grad
from voxtracer_torch.dist import multihost
from voxtracer_torch.dist.mesh import make_mesh, pad_to_multiple, render_sharded
from voxtracer_torch.dist.train import (make_mesh_2d, shard_params, train_demo)
from voxtracer_torch.dist.train import value_and_grad as sharded_value_and_grad
from voxtracer_torch.render import integrator
from voxtracer_torch.scene import presets

torch.set_num_threads(1)

SPAWN_TIMEOUT = 180.0


# the random-light whitted frame's lights: two point lights and one area
# light, (px, py, pz, r, g, b) and (px, py, pz, r, g, b, mult, radius)
RANDOM_POINTS = ((0.83, 1.57, -1.21, 2.0, 2.0, 2.0), (-1.0, 1.2, -0.8, 1.0, 0.9, 0.8))
RANDOM_AREA = ((0.3, 1.8, -0.5, 1.0, 1.0, 1.0, 0.5, 0.2),)


def _scene(name, w, h, bounces, mode=None, **cfg_kw):
    """A frame's scene and config; cfg_kw replace config fields, and
    random_lights=True gives glassbox the RANDOM_* lights with random
    light choice."""
    random_lights = cfg_kw.pop("random_lights", False)
    if name == "monu_like":
        scene, cfg = presets.monu_like_path(w, h, gridsize=16, bounces=bounces)
    else:
        scene, cfg = presets.glass_sphere_box(w, h)
        cfg = dataclasses.replace(cfg, max_bounces=bounces)
    if random_lights:
        from voxtracer_torch.scene.lights import make_lights

        scene = dataclasses.replace(scene, lights=make_lights(point=RANDOM_POINTS,
                                                              area=RANDOM_AREA))
        cfg_kw["deterministic_lights"] = False
    if mode:
        cfg_kw["mode"] = mode
    return scene, dataclasses.replace(cfg, **cfg_kw)


# frame -> (preset, width, height, bounces, mode, config fields).  "reorder"
# sorts its bounces (on 4 ranks every lane of rank 0 misses at bounce 0:
# the top two rows are sky); "random_whitted" draws light samples by queue
# slot
FRAMES = {"whitted": ("glassbox", 16, 8, 2, None, {}), "path": ("monu_like", 16, 8, 2, None, {}),
          "uneven": ("glassbox", 13, 11, 2, "path", {}),
          "reorder": ("monu_like", 16, 8, 2, None, dict(bounce_reorder="always")),
          "random_whitted": ("glassbox", 16, 8, 2, None, dict(random_lights=True)),
          "compact": ("monu_like", 16, 9, 2, None, dict(compact_chunks=3, compact_min=1)),
          "reorder_chunks": ("monu_like", 16, 9, 2, None,
                             dict(bounce_reorder="always", bounce_reorder_period=1,
                                  reorder_compact_chunks=3)),
          "sorted_whitted": ("glassbox", 16, 8, 2, None,
                             dict(random_lights=True, whitted_sort_batch=True))}


def _render_frames():
    """Every frame of FRAMES through render_sharded on this process's mesh
    -> {frame: image}, and under "<frame> stats" render_sharded's stats
    without the times."""
    torch.set_num_threads(1)
    mesh = make_mesh(device="cpu")
    out = {}
    for what, (name, w, h, bounces, mode, kw) in FRAMES.items():
        scene, cfg = _scene(name, w, h, bounces, mode, **kw)
        stats = {}
        out[what] = render_sharded(scene, cfg, make_key(0), 1, mesh, stats).numpy()
        stats["exchanges"] = [(k, b) for k, b, _ in stats["exchanges"]]
        out[f"{what} stats"] = stats
    return out


def _train_rank(iters_list, n_steps):
    """This rank's mesh, slab and first-step gradient, and the last loss of
    a train_demo of each length in iters_list."""
    torch.set_num_threads(1)
    scene, cfg = _scene("glassbox", 16, 16, 2, "path")
    mesh = make_mesh_2d(device="cpu")
    target = torch.zeros((cfg.height, cfg.width, 3))
    params = shard_params(params_from_scene(scene), mesh)
    loss, g = sharded_value_and_grad(params, scene, cfg, target, mesh, n_steps)
    losses = [train_demo(scene, cfg, target, mesh, iters=i, n_steps=n_steps, lr=5e-2)[1]
              for i in iters_list]
    return dict(shape=mesh.shape, coords=mesh.coords, slab=tuple(params.density_logits.shape),
                loss=float(loss), grad_density=g.density_logits.numpy(),
                grad_albedo=g.albedo_table.numpy(), losses=losses)


# ------------------------------------------------------------------ streams

def test_lane_windows_of_the_random_streams():
    import jax

    from voxtracer.core import rng as jax_rng

    key, total, first, m = make_key(5), 96, 40, 24
    jkey = jax.random.PRNGKey(5)
    for shape in ((total,), (3, total)):
        base = hash_bits(key, 11, shape, "cpu")
        np.testing.assert_array_equal(base.numpy().astype(np.uint32),
                                      np.asarray(jax_rng.hash_bits(jkey, 11, shape)))
        assert torch.equal(hash_bits(key, 11, shape, "cpu", (0, total)), base)
        win = shape[:-1] + (m,)
        assert torch.equal(hash_bits(key, 11, win, "cpu", (first, total)),
                           base[..., first:first + m])
    assert torch.equal(hash_normal(key, 4, (3, m), "cpu", (first, total)),
                       hash_normal(key, 4, (3, total), "cpu")[:, first:first + m])
    full = threefry_bits(key, (total, 2), "cpu")
    assert torch.equal(threefry_bits(key, (m, 2), "cpu", (first, total)), full[first:first + m])
    np.testing.assert_array_equal(
        threefry_uniform(key, (m, 2), "cpu", (first, total)).numpy(),
        np.asarray(jax.random.uniform(jkey, (total, 2)))[first:first + m])


def test_path_traced_on_a_slice_of_lanes_is_the_slice_of_the_frame():
    scene, cfg = _scene("monu_like", 16, 8, 2)
    px, py = integrator._pixel_grid(cfg, scene.device)
    o, d = integrator.primary_rays(scene.camera, cfg.width, cfg.height, px + 0.5, py + 0.25)
    o, key, n = o.contiguous(), make_key(3), px.shape[0]
    whole = integrator.trace_path(scene, cfg, o, d, key)
    assert torch.equal(integrator.trace_path(scene, cfg, o, d, key, lanes=(0, n)), whole)
    for lo, hi in ((0, 32), (32, 96), (96, 128)):
        part = integrator.trace_path(scene, cfg, o[lo:hi].contiguous(), d[lo:hi], key,
                                     lanes=(lo, n))
        assert torch.equal(part, whole[lo:hi]), (lo, hi)


# ------------------------------------------------------------------ render

@pytest.fixture(scope="module")
def frames():
    """{rank count: {frame: image}}: 1 rank in this process, 2 and 4
    spawned."""
    return {1: _render_frames(),
            2: multihost.spawn(_render_frames, 2, device="cpu", timeout=SPAWN_TIMEOUT),
            4: multihost.spawn(_render_frames, 4, device="cpu", timeout=SPAWN_TIMEOUT)}


@pytest.mark.parametrize("what", ["whitted", "path"])
def test_two_ranks_render_the_one_rank_image_bit_for_bit(frames, what):
    one = frames[1][what]
    for rank_out in frames[2]:
        np.testing.assert_array_equal(rank_out[what], one)


@pytest.mark.parametrize("ranks", [2, 4])
@pytest.mark.parametrize("what", ["reorder", "random_whitted"])
def test_ranks_share_the_global_wavefront_bit_for_bit(frames, what, ranks):
    """The frames that need the one global wavefront: every rank of 2 and
    of 4 gives the 1-rank image bit for bit, after the same exchanges
    (the reorder's state gathers; one queue indicator sum an iteration)."""
    one = frames[1][what]
    kinds = {k for k, _ in frames[1][f"{what} stats"]["exchanges"]}
    assert kinds == ({"alive", "reorder", "unpermute"} if what == "reorder" else {"queue"})
    for rank_out in frames[ranks]:
        np.testing.assert_array_equal(rank_out[what], one)
        assert ([k for k, _ in rank_out[f"{what} stats"]["exchanges"]]
                == [k for k, _ in frames[1][f"{what} stats"]["exchanges"]])


@pytest.mark.parametrize("ranks", [2, 4])
@pytest.mark.parametrize("what", ["compact", "reorder_chunks", "sorted_whitted"])
def test_ranks_render_the_option_frames_bit_for_bit(frames, what, ranks):
    """compact_chunks, reorder_compact_chunks and whitted_sort_batch act on
    the one global wavefront: every rank of 2 and of 4 gives the 1-rank
    image bit for bit, after the same exchanges.  The options ran: the
    compacted and chunked frames differ from the plain and the reordered
    one (other chunk keys), and the sorted whitted frame is the unsorted
    one (the exact queue's sort only reorders dispatch)."""
    one = frames[1][what]
    kinds = {k for k, _ in frames[1][f"{what} stats"]["exchanges"]}
    assert kinds == {"compact": {"compact", "unpermute"},
                     "reorder_chunks": {"alive", "reorder", "live", "unpermute"},
                     "sorted_whitted": {"queue"}}[what]
    for rank_out in frames[ranks]:
        np.testing.assert_array_equal(rank_out[what], one)
        assert ([k for k, _ in rank_out[f"{what} stats"]["exchanges"]]
                == [k for k, _ in frames[1][f"{what} stats"]["exchanges"]])
    if what == "sorted_whitted":
        np.testing.assert_array_equal(one, frames[1]["random_whitted"])
        return
    assert np.isfinite(one).all() and 0.02 < one.mean() < 10.0
    scene, cfg = _scene("monu_like", 16, 9, 2)
    mesh = make_mesh(device="cpu")
    for other in (cfg, dataclasses.replace(cfg, bounce_reorder="always", bounce_reorder_period=1)):
        plain = render_sharded(scene, other, make_key(0), 1, mesh).numpy()
        assert (np.abs(plain - one).max(-1) > 1e-3).mean() > 0.05


def test_four_ranks_render_the_one_rank_image_bit_for_bit(frames):
    """The frames that need no exchange, on 4 ranks (the uneven one: 143
    pixels padded to 144, 36 lanes a rank, as on 2)."""
    for rank_out in frames[4]:
        for what in ("whitted", "path"):
            np.testing.assert_array_equal(rank_out[what], frames[1][what])
            assert rank_out[f"{what} stats"]["exchanges"] == []
        np.testing.assert_array_equal(rank_out["uneven"], frames[2][0]["uneven"])


def test_a_reorder_frame_finishes_when_one_rank_has_no_hit(frames):
    """On 4 ranks rank 0's 32 lanes all miss at bounce 0, so from bounce 1
    on it has no active ray; the bounce loop stops only when no rank has
    one (a rank-local stop would leave its peers waiting in the next
    gather: the spawn would time out), and every rank sees the same
    reorders."""
    scene, cfg = _scene("monu_like", 16, 8, 2, bounce_reorder="always")
    px, py = integrator._pixel_grid(cfg, "cpu")
    u = threefry_uniform(fold_in(fold_in(make_key(0), 0), 100), (32, 2), "cpu", (0, 128))
    o, d = integrator.primary_rays(scene.camera, cfg.width, cfg.height, px[:32] + u[:, 0],
                                   py[:32] + u[:, 1])
    rec = integrator.find_nearest_world(scene, o.contiguous(), d, torch.ones(32, dtype=torch.bool))
    assert not rec["hit"].any()
    stats = [r["reorder stats"]["exchanges"] for r in frames[4]]
    assert all(s == stats[0] for s in stats) and ("reorder", 21 * 128 * 4) in stats[0]
    np.testing.assert_array_equal(frames[4][0]["reorder"], frames[1]["reorder"])


def test_uneven_pixel_count(frames):
    """143 pixels over 2 ranks: 144 lanes.  The streams are indexed over
    the padded lanes, so the path frame is another draw than the 1-rank
    one (as the JAX package's: a standing difference, ROADMAP Queue 3)."""
    img = frames[2][0]["uneven"]
    assert pad_to_multiple(13 * 11, 2) == 144
    assert img.shape == (11, 13, 3) and np.isfinite(img).all() and img.mean() > 0.02
    np.testing.assert_array_equal(frames[2][1]["uneven"], img)
    assert not np.array_equal(frames[1]["uneven"], img)


def _jax_render_sharded(name, w, h, bounces, random_lights=False, **cfg_kw):
    import jax
    import jax.numpy as jnp

    from voxtracer.config import RenderConfig as JaxConfig
    from voxtracer.dist import mesh as jax_mesh
    from voxtracer.scene import presets as jax_presets
    from voxtracer.scene.lights import make_lights

    from test_torch_render import _jax_scene

    if name == "monu_like":
        jscene = _jax_scene("monu_like", w, h)
        jcfg = JaxConfig(width=w, height=h, mode="path", max_bounces=bounces)
    else:
        jscene, jcfg = jax_presets.glass_sphere_box(w, h)
        jcfg = dataclasses.replace(jcfg, max_bounces=bounces)
    if random_lights:
        lights = make_lights(point=RANDOM_POINTS, area=RANDOM_AREA)
        jscene = jscene.replace(lights=jax.tree.map(jnp.asarray, lights))
        cfg_kw["deterministic_lights"] = False
    jcfg = dataclasses.replace(jcfg, **cfg_kw)
    with jax.disable_jit():
        return np.asarray(jax_mesh.render_sharded(jscene, jcfg, jax.random.PRNGKey(0), 1,
                                                  jax_mesh.make_mesh(1)))


def _held_as_a_path_frame(got, want):
    """tests/test_torch_render.py's path rule."""
    diff = np.abs(got - want)
    assert diff.mean() <= 1e-4, diff.mean()
    assert (diff.max(-1) > 1e-3).mean() <= 0.01


def _held_as_a_whitted_frame(got, want):
    """tests/test_torch_whitted.py's queue rule."""
    diff = np.abs(got - want)
    assert (diff > 1e-4).mean() <= 0.01, f"{(diff > 1e-4).mean():.2%} (max {diff.max()})"
    assert np.median(diff) <= 1e-6 and float(want.mean()) > 0.02


def test_one_rank_holds_to_the_jax_render_sharded(frames):
    """The port's presets build the JAX package's arrays (their parity is
    tests/test_torch_render.py's), so each side renders its own."""
    _held_as_a_path_frame(frames[1]["path"], _jax_render_sharded("monu_like", 16, 8, 2))
    _held_as_a_whitted_frame(frames[1]["whitted"], _jax_render_sharded("glassbox", 16, 8, 2))


def test_one_rank_reorder_frame_holds_to_the_jax_render_sharded(frames, monkeypatch):
    """monu_like 16x8, 2 bounces, bounce_reorder="always": the JAX
    render_sharded sorts its whole wavefront before bounce 1.  The
    reordered frame parts from the unordered one on 4 of the 128 pixels
    (3.1%: on this frame another key moves only 11% of the pixels), more
    than the 1% the path rule lets through, so the frame holds to the JAX
    one only if the reorder ran."""
    monkeypatch.setenv("VOXTRACER_PALLAS", "0")
    got = frames[1]["reorder"]
    _held_as_a_path_frame(got, _jax_render_sharded("monu_like", 16, 8, 2,
                                                   bounce_reorder="always"))
    assert 0.02 < got.mean() < 10.0
    assert (np.abs(got - frames[1]["path"]).max(-1) > 1e-3).mean() > 0.02


def test_one_rank_random_light_whitted_frame_holds_to_the_jax_render_sharded(frames):
    """Glassbox 16x8, depth 2, two point lights and one area light, random
    light choice: the JAX render_sharded runs the global FIFO queue, each
    branch drawing its light choice and area sample at its batch slot.
    The frame differs from the all-lights sum of the same scene (on 10 of
    its 128 pixels by more than 1e-3: the rest see the flat sky or the
    unlit side)."""
    got = frames[1]["random_whitted"]
    _held_as_a_whitted_frame(got, _jax_render_sharded("glassbox", 16, 8, 2, random_lights=True))
    scene, cfg = _scene("glassbox", 16, 8, 2, random_lights=True)
    summed = render_sharded(scene, dataclasses.replace(cfg, deterministic_lights=True),
                            make_key(0), 1, make_mesh(device="cpu")).numpy()
    assert (np.abs(got - summed).max(-1) > 1e-3).mean() > 0.05


def test_a_window_of_lanes_without_the_other_ranks_cannot_reorder():
    """trace_path given a window of lanes of a reordering wavefront and no
    collectives refuses it: the sort needs the other ranks' lanes."""
    scene, cfg = _scene("monu_like", 16, 8, 2, bounce_reorder="always")
    px, py = integrator._pixel_grid(cfg, scene.device)
    o, d = integrator.primary_rays(scene.camera, cfg.width, cfg.height, px, py)
    with pytest.raises(ValueError, match="reorder"):
        integrator.trace_path(scene, cfg, o[:64].contiguous(), d[:64], make_key(0),
                              lanes=(0, 128))


def test_a_window_of_lanes_without_the_other_ranks_cannot_compact():
    """Likewise the compaction, which partitions the whole wavefront."""
    scene, cfg = _scene("monu_like", 16, 8, 2, compact_chunks=4, compact_min=1)
    px, py = integrator._pixel_grid(cfg, scene.device)
    o, d = integrator.primary_rays(scene.camera, cfg.width, cfg.height, px, py)
    with pytest.raises(ValueError, match="compaction"):
        integrator.trace_path(scene, cfg, o[:64].contiguous(), d[:64], make_key(0),
                              lanes=(0, 128))


# ------------------------------------------------------------------ train

def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.fixture(scope="module")
def train_runs():
    """(the 1-rank run in this process, the 4 spawned ranks' runs)."""
    return _train_rank((1, 5), 16), multihost.spawn(_train_rank, 4, ((1, 5), 16), device="cpu",
                                                    timeout=SPAWN_TIMEOUT)


def test_four_rank_train_step_matches_one_rank_and_learns(train_runs):
    one, ranks = train_runs
    assert one["shape"] == (1, 1) and one["slab"] == (3, 8, 8, 8)
    for r, out in enumerate(ranks):
        assert out["shape"] == (2, 2) and out["coords"] == (r // 2, r % 2)
        assert out["slab"] == (3, 4, 8, 8)
        assert abs(out["loss"] - one["loss"]) <= 1e-5 * abs(one["loss"])
        assert _rel_l2(out["grad_albedo"], one["grad_albedo"]) <= 1e-4
        lo = out["coords"][1] * 4
        assert _rel_l2(out["grad_density"], one["grad_density"][:, lo:lo + 4]) <= 1e-4
        loss1, loss5 = out["losses"]
        assert np.isfinite(loss1) and np.isfinite(loss5) and loss5 < loss1
        assert abs(loss1 - one["losses"][0]) <= 1e-5 * abs(one["losses"][0])
    full = np.concatenate([ranks[0]["grad_density"], ranks[1]["grad_density"]], axis=1)
    assert _rel_l2(full, one["grad_density"]) <= 1e-4
    # the 1-rank step against the unsharded gradient of the image MSE
    scene, cfg = _scene("glassbox", 16, 16, 2, "path")
    loss, g = value_and_grad(mse_loss)(params_from_scene(scene), scene, cfg,
                                       torch.zeros((16, 16, 3)), 16)
    assert abs(float(loss) - one["loss"]) <= 1e-5 * float(loss)
    assert _rel_l2(one["grad_density"], g.density_logits.numpy()) <= 1e-4
    assert _rel_l2(one["grad_albedo"], g.albedo_table.numpy()) <= 1e-4


def test_one_rank_train_demo_holds_to_the_jax_train_demo(train_runs):
    """The JAX train_demo on a 1-device (1, 1) mesh, run op by op, from the
    same glassbox 16x16 scene (the presets build the same arrays): the
    first loss (the initial params' image MSE) within 1e-5 relative, as
    tests/test_torch_diff.py holds forward images, and the params after one
    step within 1e-5 of optax's, as it holds one Adam step.  After 5 steps
    the params are held within relative L2 1e-5 and the last loss (after 4
    updates) within 1e-4 relative: the JAX albedo adjoint rounds its
    cotangent to bf16 (tests/test_torch_diff.py), so the Adam moments part
    over the steps (here params 6e-5 apart at most, relative L2 2e-6; the
    loss 2.9e-5)."""
    import jax

    from voxtracer.diff.volumetric import params_from_scene as jax_params_from_scene
    from voxtracer.dist.train import make_mesh_2d as jax_mesh_2d
    from voxtracer.dist.train import train_demo as jax_train_demo
    from voxtracer.scene import presets as jax_presets

    jscene, jcfg = jax_presets.glass_sphere_box(16, 16)
    jcfg = dataclasses.replace(jcfg, mode="path", max_bounces=2)
    start = jax_params_from_scene(jscene)
    scene, cfg = _scene("glassbox", 16, 16, 2, "path")
    target = np.zeros((16, 16, 3), np.float32)
    for iters, rtol in ((1, 1e-5), (5, 1e-4)):
        with jax.disable_jit():
            want, want_loss = jax_train_demo(jscene, jcfg, target, jax_mesh_2d(1), iters=iters,
                                             n_steps=16, lr=5e-2)
        got, loss = train_demo(scene, cfg, torch.from_numpy(target), make_mesh_2d(device="cpu"),
                               iters=iters, n_steps=16, lr=5e-2)
        assert loss == train_runs[0]["losses"][iters > 1]
        assert abs(loss - want_loss) <= rtol * abs(want_loss), (iters, loss, want_loss)
        assert np.abs(np.asarray(want.albedo_table) - np.asarray(start.albedo_table)).max() > 1e-3
        for f in ("density_logits", "albedo_table"):
            w, g = np.asarray(getattr(want, f)), getattr(got, f).detach().numpy()
            if iters == 1:
                np.testing.assert_allclose(g, w, rtol=0, atol=1e-5)
            else:
                assert _rel_l2(g, w) <= 1e-5, (f, _rel_l2(g, w))


# ------------------------------------------------------------------ multihost

def test_jax_gather_image_loses_rows_the_port_keeps_them(monkeypatch):
    import jax
    from jax.experimental import multihost_utils

    from voxtracer.dist import multihost as jax_multihost

    height, count = 10, 3
    img = np.arange(height * 2 * 3, dtype=np.float32).reshape(height, 2, 3)
    monkeypatch.setattr(jax, "process_count", lambda: count)
    bands, jax_bounds = [], []
    for i in range(count):
        monkeypatch.setattr(jax, "process_index", lambda i=i: i)
        row0, row1 = jax_multihost.host_tile_bounds(height)
        assert (row0, row1) == multihost.tile_bounds(height, i, count)
        jax_bounds.append((row0, row1))
        bands.append(img[row0:row1])
    assert jax_bounds == [(0, 4), (4, 8), (6, 10)]
    monkeypatch.setattr(multihost_utils, "process_allgather", lambda band: np.stack(bands))
    jax_img = jax_multihost.gather_image(bands[-1], height)
    lost = [r for r in range(height) if not np.array_equal(jax_img[r], img[r])]
    assert lost == [8, 9]  # rows 6-7 twice, rows 8-9 lost
    np.testing.assert_array_equal(multihost.assemble_bands(bands, height), img)
    info = multihost.init()  # one process: a no-op
    assert info == dict(process_index=0, process_count=1, local_devices=1, global_devices=1)
    assert multihost.host_tile_bounds(height) == (0, height)
    np.testing.assert_array_equal(multihost.gather_image(torch.from_numpy(img), height), img)
