"""The port's fly camera and live viewer against the JAX package's, on
the CPU.  Mirrors tests/test_viewer.py case for case, then adds:

* the fly poses and ``to_camera`` over a random 200-frame key script:
  equal to JAX's bit for bit (both are float32 numpy, operation for
  operation);
* ``apply_edits`` for every key of the keymap: the materials, lights and
  edit cursor equal to JAX's after each key, and the caller's scene left
  as it was;
* the live frame (render, running mean, tonemap) after a 4-frame script
  with a move and an edit, on glassbox 12x12 at depth 2, against JAX's
  ``_make_live_step`` run op by op (``disable_jit``: XLA's jit contracts
  multiply-adds, which whitted's glass amplifies) in run_live's loop at a
  fixed 33 ms frame time: the accumulator within
  tests/test_torch_whitted.py's queue tolerance (at most 1% of pixels off
  by more than 1e-4, median difference <= 1e-6), the uint8 image off by
  at most one level on at most 1% of pixels;
* an edit changes the next frame and keeps the kernels' packed volume
  tables (``kernels.traverse.tables``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from voxtracer import viewer as jax_viewer
from voxtracer.render import flycam as jax_flycam
from voxtracer.render.camera import make_camera as jax_make_camera
from voxtracer.scene import presets as jax_presets
from voxtracer_torch import cli
from voxtracer_torch.kernels import traverse
from voxtracer_torch.render.camera import make_camera
from voxtracer_torch.render.flycam import (STOP_ANGLE, FlyState, handle_input,
                                           to_camera)
from voxtracer_torch.scene import presets
from voxtracer_torch.scene.convert import scene_from_numpy
from voxtracer_torch.viewer import EditState, LiveSession, apply_edits, run_live

from test_torch_render import _flatten

torch.set_num_threads(1)

CAMERA_FIELDS = ("pos", "top_left", "top_right", "bottom_left", "right", "up", "ahead",
                 "focal_distance", "defocus_jitter")


def _mk():
    cam = make_camera(pos=(0, 0, -3), target=(0, 0, 0), aspect=1.0)
    return cam, FlyState.from_camera(cam)


def test_forward_moves_along_ahead():
    cam, fly = _mk()
    changed = handle_input(fly, {"w"}, dt_ms=100.0)
    assert changed
    np.testing.assert_allclose(fly.pos, [0, 0, -3 + 0.75], atol=1e-6)


def test_idle_frame_no_change():
    cam, fly = _mk()
    assert not handle_input(fly, set(), dt_ms=100.0)
    np.testing.assert_allclose(fly.pos, [0, 0, -3])


def test_yaw_rotates_without_translating():
    cam, fly = _mk()
    handle_input(fly, {"right"}, dt_ms=100.0)
    np.testing.assert_allclose(fly.pos, [0, 0, -3])
    new = to_camera(fly, 1.0, cam)
    ahead = new.ahead.numpy()
    assert abs(np.linalg.norm(ahead) - 1.0) < 1e-5
    assert ahead[0] != 0.0  # turned toward +x (right = up x ahead)


def test_pitch_clamps_at_stop_angle():
    cam, fly = _mk()
    for _ in range(2000):
        handle_input(fly, {"up"}, dt_ms=10.0)
    ahead = (fly.target - fly.pos)
    ahead = ahead / np.linalg.norm(ahead)
    # one-step overshoot allowed (the reference clamp only stops further
    # adds, camera.h:126-140)
    assert ahead[1] <= STOP_ANGLE + 0.1
    before = fly.target.copy()
    handle_input(fly, {"up"}, dt_ms=10.0)
    np.testing.assert_allclose(fly.target, before)  # saturated: no-op


def test_to_camera_matches_make_camera_basis():
    """Rebuilt frustum corners equal make_camera's for a level pose (both
    implement camera.h:172-178)."""
    cam = make_camera(pos=(1, 2, -5), target=(1, 2, 0), aspect=256 / 212)
    fly = FlyState.from_camera(cam)
    rebuilt = to_camera(fly, 256 / 212, cam)
    for f in ("pos", "top_left", "top_right", "bottom_left", "ahead"):
        np.testing.assert_allclose(getattr(rebuilt, f).numpy(), getattr(cam, f).numpy(),
                                   atol=1e-5)


def test_fly_poses_and_cameras_equal_jax():
    keys_all = ["w", "a", "s", "d", "q", "e", "up", "down", "left", "right", "shift"]
    rng = np.random.default_rng(7)
    cam = make_camera(pos=(0.1, 1.1, -2.6), target=(0.2, 0.5, 0.5), aspect=1.5)
    jcam = jax_make_camera(pos=(0.1, 1.1, -2.6), target=(0.2, 0.5, 0.5), aspect=1.5)
    fly, jfly = FlyState.from_camera(cam), jax_flycam.FlyState.from_camera(jcam)
    for _ in range(200):
        keys = {k for k in keys_all if rng.random() < 0.3}
        dt = float(rng.uniform(5.0, 120.0))
        assert (handle_input(fly, keys, dt, slow="shift" in keys)
                == jax_flycam.handle_input(jfly, keys, dt, slow="shift" in keys))
        np.testing.assert_array_equal(fly.pos, jfly.pos)
        np.testing.assert_array_equal(fly.target, jfly.target)
        got, want = to_camera(fly, 1.5, cam), jax_flycam.to_camera(jfly, 1.5, jcam)
        for f in CAMERA_FIELDS:
            np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                          err_msg=f)


def test_scripted_live_loop_moves_and_resets():
    """Headless live loop: a move key resets the accumulator; idle frames
    accumulate; the loop completes without a TTY."""
    scene, cfg = presets.glass_sphere_box(16, 16)
    cfg = dataclasses.replace(cfg, max_bounces=2)
    script = [set(), set(), {"w"}, set()]
    frames, report = run_live(scene, cfg, script=script, display=False, max_frames=4)
    assert frames == 4 and len(report.times) == 4


def test_scripted_live_material_edit():
    scene, cfg = presets.glass_sphere_box(16, 16)
    cfg = dataclasses.replace(cfg, max_bounces=2)
    frames, _ = run_live(scene, cfg, script=[{"m"}, set()], display=False)
    assert frames == 2


def test_cli_live_scripted(capsys):
    cli.main(["live", "--preset", "glassbox", "--width", "16", "--height", "16",
              "--bounces", "2", "--script", "..w.", "--no-display", "--device", "cpu"])
    assert "live: 4 frames rendered" in capsys.readouterr().err


def test_apply_edits_keymap():
    """The live-edit keymap (EditState): slot picking, material property
    nudges with clamping, and light colour scaling; each returns
    edited=True so the loop resets the accumulator (renderer.cpp:343)."""
    scene, cfg = presets.glass_sphere_box(16, 16)
    edit = EditState(material=6)

    s2, edited = apply_edits(scene, {"3"}, edit)  # a digit picks the slot
    assert edit.material == 3 and not edited
    apply_edits(scene, {"["}, edit)  # slot stepping
    assert edit.material == 2
    apply_edits(scene, {"]"}, edit)
    assert edit.material == 3

    before = scene.materials.albedo[3].numpy().copy()
    s2, edited = apply_edits(scene, {"m"}, edit)
    assert edited
    np.testing.assert_allclose(s2.materials.albedo[3].numpy(), before * 1.25)

    s3 = scene
    for _ in range(15):
        s3, _ = apply_edits(s3, {"r"}, edit)
    assert float(s3.materials.roughness[3]) == 1.0
    s4 = scene
    for _ in range(40):
        s4, _ = apply_edits(s4, {"k"}, edit)
    assert float(s4.materials.ior[3]) == 1.0

    lb = scene.lights.point_color[0].numpy().copy()
    s5, edited = apply_edits(scene, {"u"}, edit)
    assert edited
    np.testing.assert_allclose(s5.lights.point_color[0].numpy(), lb * 1.25)
    for _ in range(scene.lights.count - 1):  # past the typed banks: the directional light
        apply_edits(scene, {"l"}, edit)
    db = scene.lights.dir_color.numpy().copy()
    s6, _ = apply_edits(scene, {"j"}, edit)
    np.testing.assert_allclose(s6.lights.dir_color.numpy(), db * 0.8)


def test_apply_edits_equal_jax_for_every_key():
    """Each key of the keymap, held for a few frames in turn on a scene
    with point, area and spot lights, through both packages."""
    jscene, jcfg = jax_presets.glass_sphere_box(16, 16)
    from voxtracer.scene.lights import make_lights as jax_make_lights

    jscene = jscene.replace(lights=jax_make_lights(
        point=((0.83, 1.57, -1.21, 2.0, 2.0, 2.0),), area=((0.0, 2.0, 0.0, 1.0, 0.9, 0.8, 2.0, 0.2),),
        spot=((0.5, 1.5, -1.0, 0.0, -1.0, 0.0, 3.0, 3.0, 3.0, 0.9),),
        directional=((0.3, -1.0, 0.2), (0.5, 0.5, 0.5))))
    scene = scene_from_numpy(_flatten(jscene), device="cpu")
    jscene = jax.tree.map(jnp.asarray, jscene)
    keep = {f.name: getattr(scene.materials, f.name).clone()
            for f in dataclasses.fields(scene.materials)}
    keep_l = {f.name: getattr(scene.lights, f.name).clone() for f in dataclasses.fields(scene.lights)}
    edit, jedit = EditState(material=6), jax_viewer.EditState(material=6)
    script = (["7", "m", "m", "n", "r", "r", "f", "g", "g", "h", "h", "h", "i", "k", "k", "k", "[",
               "m", "]", "]", "n"] + ["u", "l", "j", "u"] * 5 + ["0", "g", "9", "r"])
    cur, jcur = scene, jscene
    for ch in script:
        cur, edited = apply_edits(cur, {ch}, edit)
        jcur, jedited = jax_viewer.apply_edits(jcur, {ch}, jedit)
        assert edited == jedited and edit.material == jedit.material and edit.light == jedit.light
        for part in ("materials", "lights"):
            for f in dataclasses.fields(getattr(cur, part)):
                np.testing.assert_array_equal(getattr(getattr(cur, part), f.name).numpy(),
                                              np.asarray(getattr(getattr(jcur, part), f.name)),
                                              err_msg=f"{ch}: {part}.{f.name}")
    for k, v in keep.items():  # the caller's scene is left as it was
        assert torch.equal(getattr(scene.materials, k), v), k
    for k, v in keep_l.items():
        assert torch.equal(getattr(scene.lights, k), v), k


def _jax_live(jscene, jcfg, script, dt_ms=33.0):
    """JAX's run_live loop at a fixed frame time, op by op -> (acc, rgb8)."""
    step = jax_viewer._make_live_step()
    fly = jax_flycam.FlyState.from_camera(jscene.camera)
    edit = jax_viewer.EditState(material=6)
    acc = jnp.zeros((jcfg.height, jcfg.width, 3), jnp.float32)
    key, n_acc, scene = jax.random.PRNGKey(0), 0, jscene
    with jax.disable_jit():
        for frame, keys in enumerate(script):
            scene, edited = jax_viewer.apply_edits(scene, keys, edit)
            moved = jax_flycam.handle_input(fly, keys, dt_ms)
            if moved:
                scene = scene.replace(camera=jax.tree.map(
                    jnp.asarray, jax_flycam.to_camera(fly, jcfg.width / jcfg.height,
                                                      scene.camera)))
            if moved or edited:
                n_acc = 0
            acc, rgb = step(scene, jcfg, acc, jnp.int32(n_acc), jax.random.fold_in(key, frame), 1)
            n_acc += 1
    return np.asarray(acc), np.asarray(rgb)


def test_live_frames_match_jax_op_by_op():
    jscene, jcfg = jax_presets.glass_sphere_box(12, 12)
    jcfg = dataclasses.replace(jcfg, max_bounces=2)
    scene = scene_from_numpy(_flatten(jscene), device="cpu")
    cfg = dataclasses.replace(presets.glass_sphere_box(12, 12)[1], max_bounces=2)
    script = [set(), {"w"}, {"m"}, set()]
    want_acc, want_rgb = _jax_live(jax.tree.map(jnp.asarray, jscene), jcfg, script)
    live = LiveSession(scene, cfg)
    for keys in script:
        rgb = live.frame(keys, 33.0)
    assert live.n_acc == 2 and live.frames == 4
    diff = np.abs(live.acc.numpy() - want_acc)
    assert (diff > 1e-4).mean() <= 0.01, f"{(diff > 1e-4).mean():.2%} off (max {diff.max()})"
    assert np.median(diff) <= 1e-6
    off = np.abs(rgb.astype(np.int32) - want_rgb.astype(np.int32))
    assert off.max() <= 1 and (off > 0).mean() <= 0.01
    assert rgb.dtype == np.uint8 and rgb.shape == (12, 12, 3)


def test_an_edit_changes_the_next_frame_and_keeps_the_volume_tables():
    scene, cfg = presets.glass_sphere_box(12, 12)
    cfg = dataclasses.replace(cfg, max_bounces=2)
    vols = scene.volumes

    def tables_of(s):
        v = s.volumes
        return traverse.tables(v.grids.reshape(-1), v.gridsize, v.inv, v.fwd, v.cube_min,
                               v.occ, v.bricksize)

    before = tables_of(scene)
    plain, edited = LiveSession(scene, cfg), LiveSession(scene, cfg)
    plain.frame(set(), 33.0)
    edited.frame(set(), 33.0)
    a = plain.frame(set(), 33.0)
    b = edited.frame({"1", "m"}, 33.0)  # the red floor's albedo x1.25
    assert edited.n_acc == 1 and plain.n_acc == 2
    assert not np.array_equal(a, b)
    moved = edited.frame({"d"}, 33.0)
    assert edited.scene.volumes is vols and tables_of(edited.scene) is before
    assert not np.array_equal(moved, b)
