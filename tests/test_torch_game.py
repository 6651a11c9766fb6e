"""The port's game layer against the JAX package's, on the CPU.

The player, the props and the levels are host numpy in both packages:
after every step the two games must hold equal volumes, lights, spheres,
triangles, materials, states, player poses and random-generator states,
and equal scenes.  The level files are the stand-ins
``chip_smoke.write_standin_assets`` writes from a seed.

The probe's skip-range walk (``find_nearest_world(..., skip_lo=9,
skip_hi=14, skip_first=True)``) against the JAX package's ``dda.traverse``
route under jit: hit, vol and material identical, t within 1e-6
relative, normals identical.  The light kill (``render_game_frame``,
``trace_path(return_aux=True)``) on tests/test_game.py's lit and dark
scenes at 16^2, 2 bounces, against the JAX package run op by op
(``disable_jit``): flags equal, per ray and per frame; images at
tests/test_torch_render.py's path tolerances (mean absolute difference
<= 1e-4, at most 1% of pixels off by more than 1e-3).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import write_standin_assets
from voxtracer.config import RenderConfig as JaxConfig
from voxtracer.core.types import SMOKE_PLAYER
from voxtracer.game import level as jax_level
from voxtracer.game import player as jax_player
from voxtracer.game import props as jax_props
from voxtracer.render import integrator as jax_integrator
from voxtracer.scene import presets as jax_presets
from voxtracer.scene.instances import VolumeSpec as JaxVolumeSpec
from voxtracer.scene.instances import build_volumes as jax_build_volumes
from voxtracer.scene.lights import make_lights as jax_make_lights
from voxtracer.scene.materials import default_materials as jax_default_materials
from voxtracer.scene.volume import solid_grid as jax_solid_grid
from voxtracer_torch import cli
from voxtracer_torch.config import RenderConfig
from voxtracer_torch.core.rng import make_key
from voxtracer_torch.game import level, player, props
from voxtracer_torch.render import integrator
from voxtracer_torch.scene import presets
from voxtracer_torch.scene.convert import scene_from_numpy

from test_torch_render import _flatten
from test_torch_vox import _same_scene

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    d = tmp_path_factory.mktemp("vox")
    write_standin_assets(str(d), 0)
    return d


def _same(a, b, what):
    if a is None or b is None:
        assert a is None and b is None, what
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=what)


def _same_player(p, q):
    for f in dataclasses.fields(p.s):
        _same(getattr(p.s, f.name), getattr(q.s, f.name), f.name)


@pytest.mark.parametrize("key", ["w", "a", "s", "d"])
def test_player_matches_jax(key):
    """probe_ray after each key, move onto all six faces, revert to the
    snapshot, and _model_offset of every face."""
    p, q = player.PlayerCharacter(), jax_player.PlayerCharacter()
    assert p.update_input(key) and q.update_input(key)
    for a, b in zip(p.probe_ray(), q.probe_ray()):
        _same(a, b, "probe_ray")
    p.snapshot((0.25, 0.0, -0.25))
    q.snapshot((0.25, 0.0, -0.25))
    faces = [(0, 1, 0), (0, -1, 0), (1, 0, 0), (-1, 0, 0), (0, 0, 1), (0, 0, -1)]
    for i, face in enumerate(faces):
        n = np.asarray(face, np.float32)
        _same(player._model_offset(n), jax_player._model_offset(n), f"offset {face}")
        point = (0.5 * i, 1.0 - i, -2.0 * i)
        for a, b in zip(p.move(point, n), q.move(point, n)):
            _same(a, b, f"move {face}")
        assert p.update_input(key) and q.update_input(key)
        _same_player(p, q)
    for a, b in zip(p.revert(), q.revert()):
        _same(a, b, "revert")
    _same_player(p, q)
    assert not p.update_input("x")


def test_modifying_prop_matches_jax(assets):
    path = str(assets / "monu2.vox")
    p = props.ModifyingProp(path, 64, period=0.5, starting_index=16, increase_rate=16)
    q = jax_props.ModifyingProp(path, 64, period=0.5, starting_index=16, increase_rate=16)
    grids = 0
    for dt in (0.1, 0.5, 0.6, 0.2, 1.0, 1.0, 1.0, 1.0, 0.3, 1.0):
        a, b = p.update(dt), q.update(dt)
        _same(a, b, f"dt {dt}")
        grids += a is not None
        assert (p.index, p.changed) == (q.index, q.changed)
    assert grids == 7


def _same_game(g, j):
    assert len(g.volumes) == len(j.volumes)
    for i, (a, b) in enumerate(zip(g.volumes, j.volumes)):
        for f in ("position", "scale", "rotation", "rot_mat4", "grid"):
            _same(getattr(a, f), getattr(b, f), f"volume {i} {f}")
        assert a.gridsize == b.gridsize, i
    for f in ("point_lights", "spot_lights", "area_lights", "cam_pos", "cam_target"):
        _same(getattr(g, f), getattr(j, f), f)
    for f in ("spheres", "triangles"):
        assert len(getattr(g, f)) == len(getattr(j, f)), f
        for a, b in zip(getattr(g, f), getattr(j, f)):
            for x, y in zip(a, b):
                _same(x, y, f)
    for f in ("albedo", "roughness", "emissive", "ior"):
        _same(getattr(g.materials, f).numpy(), getattr(j.materials, f), f)
    assert list(g.mat_updates) == list(j.mat_updates)
    for k in g.mat_updates:
        _same(g.mat_updates[k], j.mat_updates[k], f"update {k}")
    assert dataclasses.asdict(g.state) == dataclasses.asdict(j.state)
    assert g.dirty == j.dirty
    _same_player(g.player, j.player)
    for a, b in zip(g.props, j.props):
        assert (a is None) == (b is None)
        if a is not None:
            assert (a.index, a._elapsed) == (b.index, b._elapsed)
    assert g.rng.bit_generator.state == j.rng.bit_generator.state


def _same_built(g, j):
    _same_scene(g.build_scene(32, 26, device="cpu"), _flatten(j.build_scene(32, 26)))


def test_game_progression_matches_jax(assets):
    """tests/test_game.py's scripted progression through chunks 1, 2 and 3
    (zone 2, the props, the win text), the props' window sliding, and the
    light-kill revert, both games compared after every tick."""
    g, j = level.Game(seed=3, asset_dir=str(assets)), jax_level.Game(seed=3, asset_dir=str(assets))
    _same_game(g, j)
    _same_built(g, j)

    def fake_probe(game):
        def probe(o, d, dist):
            point = np.array([0.0, 0.0, game.state.trigger_checkpoint - 1.0], np.float32)
            return 1, 1.0, point, np.array([0.0, 1.0, 0.0], np.float32)
        return probe

    for chunk in (1, 2, 3):
        g.tick(0.016, "w", fake_probe(g))
        j.tick(0.016, "w", fake_probe(j))
        assert g.state.current_chunk == chunk
        _same_game(g, j)
        if chunk == 2:  # the props slide their windows
            for _ in range(2):
                g.tick(1.0, None, fake_probe(g))
                j.tick(1.0, None, fake_probe(j))
                _same_game(g, j)
        _same_built(g, j)
    assert g.area_lights and g.spheres and any(p is not None for p in g.props)
    for game in (g, j):  # the light kill reverts to the checkpoint
        game.tick(0.016, None, fake_probe(game), in_light=True)
    assert g.state.static_camera
    _same_game(g, j)
    for game in (g, j):
        game.tick(6.0, "d", fake_probe(game))
    assert g.state.won
    _same_game(g, j)


def _game_rays(game, n=256):
    """The probe rays of the four moves from the start, then n seeded rays
    around the first zone -> (o, d) [4 + n, 3] f32."""
    o, d = [], []
    for key in "wasd":
        game.player.update_input(key)
        oo, dd, _ = game.player.probe_ray()
        o.append(oo)
        d.append(dd)
    rng = np.random.default_rng(7)
    ro = rng.uniform(-3.0, 3.0, (n, 3)).astype(np.float32)
    ro[:, 1] = rng.uniform(-1.0, 3.0, n)
    rd = rng.normal(size=(n, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    return (np.concatenate([np.asarray(o, np.float32), ro]),
            np.concatenate([np.asarray(d, np.float32), rd]).astype(np.float32))


def _jax_probe(scene, o, d):
    """The JAX package's probe walk on one ray (jitted ``dda.traverse``;
    the compiled walk is shared with the CLI test's probes)."""
    return jax_integrator.find_nearest_world(scene, jnp.asarray(o)[None], jnp.asarray(d)[None],
                                             jnp.ones(1, bool), skip_lo=9, skip_hi=14,
                                             skip_first=True)


def test_skip_range_walk_matches_jax(assets):
    """The port walks all rays in one call, the JAX package one ray a call
    (a ray's walk does not depend on the others)."""
    j = jax_level.Game(seed=0, asset_dir=str(assets))
    jscene = j.build_scene(32, 26)
    scene = scene_from_numpy(_flatten(jscene), device="cpu")
    jscene = jax.tree.map(jnp.asarray, jscene)
    o, d = _game_rays(j)
    n = o.shape[0]
    recs = [_jax_probe(jscene, o[i], d[i]) for i in range(n)]
    want = {f: np.concatenate([np.asarray(r[f]) for r in recs]) for f in recs[0]}
    got = integrator.find_nearest_world(scene, torch.from_numpy(o), torch.from_numpy(d),
                                        torch.ones(n, dtype=torch.bool), skip_lo=9,
                                        skip_hi=14, skip_first=True)
    for f in ("hit", "vol", "mat", "nx", "ny", "nz"):
        np.testing.assert_array_equal(got[f].numpy(), want[f], err_msg=f)
    np.testing.assert_allclose(got["t"].numpy(), want["t"], rtol=1e-6, atol=0)
    vols = got["vol"].numpy()
    assert (vols > 0).sum() > 40 and (vols == -2).sum() > 40 and not (vols == 0).any()
    # without the skip range the player's smoke cells and the smoke volume are hits
    plain = integrator.find_nearest_world(scene, torch.from_numpy(o), torch.from_numpy(d),
                                          torch.ones(n, dtype=torch.bool))
    m = plain["mat"].numpy()
    assert ((m >= 9) & (m <= 14)).any() and not ((got["mat"].numpy() >= 9)
                                                 & (got["mat"].numpy() <= 14)).any()


def _light_kill_scenes():
    """tests/test_game.py:118-156: a 4^3 SMOKE_PLAYER volume with the
    palette's albedo, lit by a point light of 500 or of 1e-4 -> {name:
    (JAX scene, port scene)}."""
    vols = jax_build_volumes([JaxVolumeSpec(position=(0, 0, 0), gridsize=4,
                                            grid=jax_solid_grid(4, SMOKE_PLAYER))])
    mats = jax_default_materials()
    alb = np.array(mats.albedo)
    alb[SMOKE_PLAYER] = (1.0, 0.7, 1.0)
    mats = mats.replace(albedo=alb)
    out = {}
    for name, c in (("lit", 500.0), ("dark", 1e-4)):
        lights = jax_make_lights(point=((0.0, 0.0, -1.2, c, c, c),))
        js = jax_presets._assemble(vols, mats, lights=lights)
        out[name] = (jax.tree.map(jnp.asarray, js), scene_from_numpy(_flatten(js), device="cpu"))
    return out


def _hold_path(got, want):
    diff = np.abs(np.asarray(got) - np.asarray(want))
    assert diff.mean() <= 1e-4 and (diff.max(-1) > 1e-3).mean() <= 0.01


@pytest.mark.parametrize("reorder", ["none", "always"])
def test_light_kill_matches_jax(reorder):
    """The per-ray flags and radiance of one sample (trace_path with
    return_aux, through _sample_pixels) on the lit and the dark scene;
    render_game_frame's flag and image on the lit one."""
    kw = dict(width=16, height=16, mode="path", max_bounces=2, detect_light_kill=True,
              activate_sky=False, bounce_reorder=reorder)
    cfg, jcfg = RenderConfig(**kw), JaxConfig(**kw)
    key, jkey = make_key(0), jax.random.PRNGKey(0)
    px, py = integrator._pixel_grid(cfg, torch.device("cpu"))
    for name, (jscene, scene) in _light_kill_scenes().items():
        rad, aux = integrator._sample_pixels(scene, cfg, key, px, py, return_aux=True)
        with jax.disable_jit():
            jrad, jaux = jax_integrator._sample_pixels(
                jscene, jcfg, jkey, jnp.asarray(px.numpy()), jnp.asarray(py.numpy()),
                return_aux=True)
        np.testing.assert_array_equal(aux["in_light"].numpy(), np.asarray(jaux["in_light"]))
        assert bool(aux["in_light"].any()) == (name == "lit"), name
        _hold_path(rad.numpy(), jrad)
        img, lit = integrator.render_game_frame(scene, cfg, key, 1)
        assert bool(lit) == (name == "lit"), name
        if name == "lit" and reorder == "none":
            with jax.disable_jit():
                jimg, jlit = jax_integrator.render_game_frame(jscene, jcfg, jkey, 1)
            assert bool(jlit)
            _hold_path(img.numpy(), jimg)
    # without the flag the state carries no in_light and the aux is all false
    off = dataclasses.replace(cfg, detect_light_kill=False)
    _, lit = integrator.render_game_frame(scene, off, key, 1)
    assert not bool(lit)


def test_cli_play_matches_jax_game(assets, tmp_path, monkeypatch):
    """cli play --steps 3 --light-kill at 32x26 on the CPU writes a PNG;
    JAX's Game driven by the same moves through JAX's probe, with the
    port's light-kill observations, ends in the same state."""
    monkeypatch.setattr(presets, "ASSET_DIR", str(assets))
    seen = []
    tick = level.Game.tick

    def spy(self, dt, keydir, probe, revert_key=False, in_light=None):
        seen.append((dt, keydir, in_light))
        return tick(self, dt, keydir, probe, revert_key, in_light)

    monkeypatch.setattr(level.Game, "tick", spy)
    games = []
    init = level.Game.__init__

    def keep(self, *a, **kw):
        init(self, *a, **kw)
        games.append(self)

    monkeypatch.setattr(level.Game, "__init__", keep)
    out = tmp_path / "game.png"
    cli.main(["play", "--steps", "3", "--light-kill", "--width", "32", "--height", "26",
              "--device", "cpu", "--output", str(out)])
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    assert [s[:2] for s in seen] == [(0.1, "w")] * 3 and all(s[2] is not None for s in seen)

    j = jax_level.Game(seed=0, asset_dir=str(assets))
    scene = None

    def probe(o, d, dist):  # the JAX CLI's probe (voxtracer/cli.py:114-126)
        nonlocal scene
        if scene is None or j.dirty:
            scene = jax.tree.map(jnp.asarray, j.build_scene(32, 26))
        rec = _jax_probe(scene, o, d)
        t = float(rec["t"][0])
        return (int(rec["vol"][0]), t, np.asarray(o) + min(t, dist) * np.asarray(d),
                np.asarray(rec["normal"][0]))

    for dt, keydir, in_light in seen:
        j.tick(dt, keydir, probe, in_light=in_light)
    j.build_scene(32, 26)  # as cmd_play builds its last frame's scene
    (g,) = games
    _same_game(g, j)
    assert g.volumes[0].position != (0.0, 0.0, 0.0)
