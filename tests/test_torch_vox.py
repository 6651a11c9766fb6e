"""The port's .vox loading, grid ingest and asset presets against the JAX
package's, on the CPU.

The parsers, ``grid_from_vox``, the palette mutations and the presets'
scenes are host numpy in both packages and must be equal bit for bit.
The MagicaVoxel files are not in the repository, so the presets and the
file cases read the stand-ins ``chip_smoke.write_standin_assets`` writes
from a seed (the JAX ``presets.ASSET_DIR`` and the port's monkeypatched
to them).  Frames: teapot_primary (primary) within 1e-6, as
tests/test_torch_render.py's primary frames; room_whitted (whitted, depth
2) with test_torch_whitted.py's rule against the JAX branch queue run op
by op.
"""

import dataclasses
import os
import struct
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import STANDIN_FILES, write_standin_assets
from voxtracer.config import RenderConfig as JaxConfig
from voxtracer.io import vox as jax_vox
from voxtracer.io.image import read_png
from voxtracer.render import integrator as jax_integrator
from voxtracer.scene import lights as jax_lights
from voxtracer.scene import materials as jax_materials
from voxtracer.scene import presets as jax_presets
from voxtracer.scene import volume as jax_volume
from voxtracer_torch import native
from voxtracer_torch.core.rng import make_key
from voxtracer_torch.io import vox
from voxtracer_torch.render import integrator
from voxtracer_torch.scene import instances, lights, materials, presets, volume
from voxtracer_torch.scene.convert import scene_from_numpy

from test_torch_render import _flatten
from test_torch_whitted import _hold, _rays

torch.set_num_threads(1)


def _chunk(cid, content, children=b""):
    return cid + struct.pack("<ii", len(content), len(children)) + content + children


def _vox(models, palette=None, imap=None, magic=b"VOX "):
    """.vox bytes: models = [(size, [(x, y, z, index), ...]), ...]."""
    kids = b""
    for size, voxels in models:
        kids += _chunk(b"SIZE", struct.pack("<iii", *size))
        kids += _chunk(b"XYZI", struct.pack("<i", len(voxels)) + bytes(np.asarray(
            voxels, np.uint8).ravel()))
    if palette is not None:
        kids += _chunk(b"RGBA", bytes(np.asarray(palette, np.uint8).ravel()))
    if imap is not None:
        kids += _chunk(b"IMAP", bytes(np.asarray(imap, np.uint8)))
    return magic + struct.pack("<i", 150) + _chunk(b"MAIN", b"", kids)


def _palette(seed):
    pal = np.random.default_rng(seed).integers(0, 256, (256, 4)).astype(np.uint8)
    pal[:, 3] = 255
    return pal


def _shuffled_imap(seed, last_zero):
    """A display order: MagicaVoxel's identity order (1, ..., 255, 0)
    shuffled past slot 16, with 0 kept last or moved into the shuffle."""
    imap = ((np.arange(256) + 1) & 0xFF).astype(np.uint8)
    hi = 255 if last_zero else 256
    imap[16:hi] = np.random.default_rng(seed).permutation(imap[16:hi])
    return imap


CASES = {
    "one voxel": _vox([((3, 2, 4), [(1, 0, 2, 5)])], _palette(0)),
    "imap": _vox([((2, 2, 2), [(0, 0, 0, 7), (1, 1, 1, 200), (1, 0, 1, 16)])], _palette(1),
                 _shuffled_imap(1, True)),
    "no rgba": _vox([((2, 3, 2), [(0, 1, 1, 9), (1, 2, 0, 250)])]),
    "out of range": _vox([((2, 2, 2), [(0, 0, 0, 3), (2, 0, 0, 4), (0, 5, 1, 6),
                                       (1, 1, 7, 8)])], _palette(2)),
    "several models": _vox([((2, 2, 2), [(1, 1, 1, 3)]), ((4, 1, 3), [(3, 0, 2, 9)]),
                            ((1, 1, 1), [])], _palette(3)),
}


def _same_models(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.grid.dtype == b.grid.dtype == np.uint8 and a.palette.dtype == np.float32
        np.testing.assert_array_equal(a.grid, b.grid)
        np.testing.assert_array_equal(a.palette, b.palette)


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    d = tmp_path_factory.mktemp("vox")
    write_standin_assets(str(d), 0)
    return d


@pytest.fixture
def asset_dir(assets, monkeypatch):
    """Both packages' presets read the stand-ins."""
    monkeypatch.setattr(jax_presets, "ASSET_DIR", str(assets))
    monkeypatch.setattr(presets, "ASSET_DIR", str(assets))
    return assets


@pytest.mark.parametrize("case", sorted(CASES))
def test_parse_vox_matches_jax(case):
    _same_models(vox.parse_vox(CASES[case]), jax_vox.parse_vox(CASES[case]))


def test_parse_vox_rejects_bad_magic():
    bad = _vox([((1, 1, 1), [(0, 0, 0, 1)])], magic=b"NOPE")
    for parse in (vox.parse_vox, jax_vox.parse_vox):
        with pytest.raises(ValueError):
            parse(bad)


@pytest.mark.parametrize("name", sorted(STANDIN_FILES))
def test_standin_files_parse_as_in_jax(assets, name):
    """Each stand-in, through load_vox (the native parser here) and the
    numpy parser, equals the JAX numpy parser's model; the files carry the
    IMAP and scene-graph chunks they claim."""
    path = str(assets / name)
    data = open(path, "rb").read()
    (want,) = jax_vox.parse_vox(data)
    got, parser = vox.load_vox_with_parser(path)
    assert parser == "native"
    _same_models([got, vox.load_vox(path, prefer_native=False)], [want, want])
    assert want.size == STANDIN_FILES[name][0] and want.grid.any()
    for cid in STANDIN_FILES[name][1]:
        assert cid.encode() in data


@pytest.fixture
def fresh_build(tmp_path, monkeypatch):
    """The native library built anew into a copy of the build directory."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_libs", {})
    return tmp_path / "build"


def test_native_parser_matches_numpy(fresh_build):
    assert native.available() and native.library_path().parent == fresh_build
    for case, data in CASES.items():
        grid, pal = native.parse_vox_native(data)
        (want, *_) = vox.parse_vox(data)
        np.testing.assert_array_equal(grid, want.grid, err_msg=case)
        np.testing.assert_array_equal(pal, want.palette, err_msg=case)
    assert native.parse_vox_native(b"NOPE" + CASES["one voxel"][4:]) is None


def test_native_and_numpy_parsers_part_on_an_imap_without_zero_last():
    """A standing difference of the JAX package's two parsers, kept by the
    port's: with an IMAP whose last entry is not 0 the numpy parser remaps
    the empty cells too (remap[0] != 0), the C++ parser only the voxels."""
    data = _vox([((2, 2, 2), [(0, 0, 0, 7)])], _palette(4), _shuffled_imap(4, False))
    (mine,), (theirs,) = vox.parse_vox(data), jax_vox.parse_vox(data)
    np.testing.assert_array_equal(mine.grid, theirs.grid)
    grid, _ = native.parse_vox_native(data)
    assert grid[0, 0, 0] == mine.grid[0, 0, 0] and (grid == 0).sum() == 7
    assert (mine.grid != 0).all()


def test_native_build_is_safe_under_concurrent_builders(fresh_build):
    """Six processes build the library into one empty directory at once:
    each gets a loadable library and one file is left."""
    code = ("import pathlib, sys; from voxtracer_torch import native; "
            f"native.BUILD_DIR = pathlib.Path({str(fresh_build)!r}); "
            "sys.exit(0 if native.available() else 1)")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(sys.path))
    procs = [subprocess.Popen([sys.executable, "-c", code], env=env) for _ in range(6)]
    assert [p.wait(timeout=120) for p in procs] == [0] * 6
    assert [p.name for p in fresh_build.iterdir()] == [native.library_path().name]


def test_native_bricks_and_png(fresh_build, tmp_path):
    rng = np.random.default_rng(1)
    for g in (8, 20, 64):
        grid = np.where(rng.random((g, g, g)) < 0.15, rng.integers(0, 16, (g, g, g)),
                        255).astype(np.uint8)
        grid[:8, :8, :8] = 3  # one uniform brick
        got = native.build_bricks_native(grid, g)
        native._libs[native.library_path()] = None  # the numpy builder
        want = instances.build_bricks(grid, g)
        native._libs.clear()
        np.testing.assert_array_equal(got, want)
        assert got[0, 0, 0] == 3
    img = rng.integers(0, 255, (20, 30, 3)).astype(np.uint8)
    assert native.write_png_native(str(tmp_path / "t.png"), img)
    np.testing.assert_array_equal(read_png(str(tmp_path / "t.png")), img)


def test_grid_from_vox_matches_jax(assets):
    """The downscale (TallBuilding01, 80 wide, into 64^3 and 16^3), the
    column window (monu2), the material override under one rng (Text) and
    the material updates in np.unique order (room), exactly."""
    def both(name):
        return (vox.load_vox(str(assets / name)), jax_vox.load_vox(str(assets / name),
                                                                   prefer_native=False))

    tall, jtall = both("TallBuilding01.vox")
    for g in (64, 16):
        np.testing.assert_array_equal(volume.grid_from_vox(tall, g),
                                      jax_volume.grid_from_vox(jtall, g))
    monu2, jmonu2 = both("monu2.vox")
    for window in ((16, 16), (48, 16), (64, 13)):
        np.testing.assert_array_equal(volume.grid_from_vox(monu2, 64, column_window=window),
                                      jax_volume.grid_from_vox(jmonu2, 64,
                                                               column_window=window))
    text, jtext = both("Text.vox")
    rngs = np.random.default_rng(5), np.random.default_rng(5)
    got = volume.grid_from_vox(text, 32, material_override=lambda: int(rngs[0].uniform(12, 13)))
    want = jax_volume.grid_from_vox(jtext, 32,
                                    material_override=lambda: int(rngs[1].uniform(12, 13)))
    np.testing.assert_array_equal(got, want)
    assert rngs[0].random() == rngs[1].random()
    room, jroom = both("room.vox")
    upd, jupd = {}, {}
    np.testing.assert_array_equal(volume.grid_from_vox(room, 128, material_updates=upd),
                                  jax_volume.grid_from_vox(jroom, 128, material_updates=jupd))
    assert list(upd) == list(jupd) and len(upd) > 100
    for k in upd:
        np.testing.assert_array_equal(upd[k], jupd[k])

    mats = materials.apply_palette_updates(materials.default_materials(), upd)
    jmats = jax_materials.apply_palette_updates(jax_materials.default_materials(), jupd)
    r1, r2 = np.random.default_rng(9), np.random.default_rng(9)
    mats = materials.randomize_smoke_colors(mats, r1)
    jmats = jax_materials.randomize_smoke_colors(jmats, r2)
    for f in ("albedo", "roughness", "emissive", "ior"):
        np.testing.assert_array_equal(getattr(mats, f).numpy(), np.asarray(getattr(jmats, f)))
    sphere = volume.grid_from_vox(monu2, 32)
    np.testing.assert_array_equal(volume.emissive_sphere(sphere, 15, 9.5),
                                  jax_volume.emissive_sphere(sphere, 15, 9.5))


def test_default_lights_match_jax():
    assert lights.default_spot() == jax_lights.default_spot()
    got, want = lights.default_lights(), jax_lights.default_lights()
    for f in dataclasses.fields(got):
        np.testing.assert_array_equal(getattr(got, f.name).numpy(),
                                      np.asarray(getattr(want, f.name)), err_msg=f.name)


PRESET_CASES = {
    "teapot_primary": dict(gridsize=16),
    "room_whitted": dict(gridsize=16),
    "room_whitted glass": dict(gridsize=16, glass=True),
    "monu_path": dict(gridsize=16),
    "city_path": dict(gridsize=16),
    "city_xl_path": dict(gridsize=16),
}


def _same_scene(got, want_tree):
    want = scene_from_numpy(want_tree, device="cpu")
    for part in ("volumes", "materials", "lights", "spheres", "triangles", "sky", "camera"):
        a, b = getattr(got, part), getattr(want, part)
        for f in dataclasses.fields(a):
            x, y = getattr(a, f.name), getattr(b, f.name)
            if isinstance(x, torch.Tensor):
                np.testing.assert_array_equal(x.numpy(), y.numpy(), err_msg=f"{part}.{f.name}")
            elif f.name == "pages" and x is not None:
                assert [(p.vol_off, p.n) for p in x] == [(p.vol_off, p.n) for p in y]
            else:
                assert x == y, f"{part}.{f.name}"


@pytest.mark.parametrize("case", sorted(PRESET_CASES))
def test_asset_presets_match_jax(asset_dir, case):
    name, kw = case.split()[0], PRESET_CASES[case]
    jscene, jcfg = getattr(jax_presets, name)(24, 16, **kw)
    scene, cfg = getattr(presets, name)(24, 16, **kw)
    _same_scene(scene, _flatten(jscene))
    for f in dataclasses.fields(cfg):
        if hasattr(jcfg, f.name):
            assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    assert (scene.volumes.pages is not None) == (name == "city_xl_path")


def test_cli_names_the_jax_presets():
    from voxtracer import cli as jax_cli

    assert set(jax_cli.PRESETS) <= set(presets.PRESETS)
    assert presets.PRESETS["roomglass"].keywords == dict(glass=True)


def test_teapot_primary_frame_matches_jax(asset_dir):
    jscene, jcfg = jax_presets.teapot_primary(24, 16, gridsize=16)
    _, cfg = presets.teapot_primary(24, 16, gridsize=16)
    tscene = scene_from_numpy(_flatten(jscene), device="cpu")
    want = jax_integrator.render(jax.tree.map(jnp.asarray, jscene), jcfg, jax.random.PRNGKey(0))
    got = integrator.render(tscene, cfg, make_key(0))
    assert float((np.asarray(want) != 0).mean()) > 0.2
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_room_whitted_frame_matches_jax(asset_dir):
    """The room at depth 2, its glass floor split (whitted_glass_split)."""
    jscene, jcfg = jax_presets.room_whitted(16, 16, gridsize=16)
    scene, cfg = presets.room_whitted(16, 16, gridsize=16)
    jcfg = dataclasses.replace(jcfg, max_bounces=2)
    cfg = dataclasses.replace(cfg, max_bounces=2)
    jscene = jax.tree.map(jnp.asarray, jscene)
    (jo, jd), (o, d) = _rays(cfg, (jscene.camera, scene.camera))
    with jax.disable_jit():
        want = jax_integrator.trace_whitted_iter(jscene, jcfg, jo, jd, 2)
    got = integrator.trace_whitted_iter(scene, cfg, o, d, 2)
    _hold(got.numpy(), want)
    # without the split a glass hit ends its branch: less light in the frame
    cut = integrator.trace_whitted_iter(
        scene, dataclasses.replace(cfg, whitted_glass_split=False), o, d, 2)
    with jax.disable_jit():
        jcut = jax_integrator.trace_whitted_iter(
            jscene, dataclasses.replace(jcfg, whitted_glass_split=False), jo, jd, 2)
    _hold(cut.numpy(), jcut)
    assert float(cut.sum()) < float(got.sum())
