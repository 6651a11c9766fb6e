"""Scene presets (counterpart of voxtracer/scene/presets.py).

Each builder returns ``(Scene, RenderConfig)`` with CPU tensors; move the
scene with ``scene.to(device)`` (``cli render`` moves it to ``--device``).

The asset presets read MagicaVoxel files from ``ASSET_DIR`` (the
``VOX_ASSETS`` environment variable, else the repository's ``assets/``
directory, where the files go once they are in the repository):
``teapot_primary``, ``room_whitted`` (``glass=True``:
roomGlass.vox), ``monu_path``, ``city_path`` and ``city_xl_path``, with
the JAX package's cameras, lights and configs.  The path presets take
``spp=`` into their RenderConfig, as the JAX package's do; the renderers
take spp as an argument.

The asset-free presets stand in for scenes whose files are not in the
repository:

* ``monu_like_path``: the monu path-tracing scene (presets.monu_path) with
  three procedural noise volumes standing in for the monu1-3 ``.vox``
  models, which are not in the repository.
* ``glass_sphere_box``: the small dielectric test box, rendered whitted.
* ``media_path``: the glass box plus a smoke volume, path traced, so rays
  march through both glass and smoke.
* ``city_xl_like_path``: a stand-in for the 111-volume city scene
  (presets.city_xl_path) in its layout, with three procedural building
  grids for the SmallBuilding01/02 and TallBuilding01 ``.vox`` models,
  which are not in the repository.  The one preset past 64 volumes: its
  volume set is paginated.
"""

from __future__ import annotations

import dataclasses
import functools
import os
import pathlib

import numpy as np
import torch

from voxtracer_torch.config import RenderConfig
from voxtracer_torch.core.types import GLASS, Scene, Sky
from voxtracer_torch.io.hdr import procedural_sky
from voxtracer_torch.io.vox import load_vox
from voxtracer_torch.render.camera import make_camera
from voxtracer_torch.scene.instances import (VolumeSpec, build_volumes,
                                             make_spheres, make_triangles,
                                             paginate_volumes)
from voxtracer_torch.scene.lights import make_lights
from voxtracer_torch.scene.materials import apply_palette_updates, default_materials
from voxtracer_torch.scene.procgen import (generate_noise_grid,
                                           generate_smoke_grid)
from voxtracer_torch.scene.volume import grid_from_vox, solid_grid

ASSET_DIR = os.environ.get("VOX_ASSETS",
                           str(pathlib.Path(__file__).resolve().parents[2] / "assets"))


def _sky(width=512, height=256, contribution=1.0) -> Sky:
    return Sky(pixels=torch.from_numpy(procedural_sky(width, height)),
               contribution=torch.tensor(contribution, dtype=torch.float32))


def _assemble(volumes, materials, lights=None, camera=None, sky=None) -> Scene:
    return Scene(volumes=volumes, materials=materials,
                 lights=lights if lights is not None else make_lights(point=()),
                 spheres=make_spheres(), triangles=make_triangles(),
                 sky=sky if sky is not None else _sky(),
                 camera=camera if camera is not None else make_camera())


def _load_grid(name: str, gridsize: int, updates: dict | None = None) -> np.ndarray:
    return grid_from_vox(load_vox(os.path.join(ASSET_DIR, name)), gridsize,
                         material_updates=updates)


def teapot_primary(width=256, height=256, gridsize=128):
    """Config 1 (presets.py:48-60): teapot.vox, primary rays only, flat
    albedo, pinhole."""
    updates: dict = {}
    grid = _load_grid("teapot.vox", gridsize, updates)
    mats = apply_palette_updates(default_materials(), updates)
    vols = build_volumes([VolumeSpec(position=(0, 0, 0), gridsize=gridsize, grid=grid)])
    cam = make_camera(pos=(0.5, 0.55, -1.1), target=(0.5, 0.3, 0.5), aspect=width / height)
    cfg = RenderConfig(width=width, height=height, mode="primary", max_bounces=1,
                       activate_sky=False)
    return _assemble(vols, mats, camera=cam), cfg


def room_whitted(width=512, height=512, gridsize=128, glass=False):
    """Configs 2/3 (presets.py:63-87): room.vox, or roomGlass.vox with
    glass, whitted with two point lights from an interior corner; both
    palettes use slot 8 (GLASS) for the floor, so the Fresnel split is on."""
    updates: dict = {}
    grid = _load_grid("roomGlass.vox" if glass else "room.vox", gridsize, updates)
    mats = apply_palette_updates(default_materials(), updates)
    vols = build_volumes([VolumeSpec(position=(0, 0, 0), gridsize=gridsize, grid=grid)])
    lights = make_lights(point=((0.5, 0.85, 0.5, 4.0, 4.0, 4.0), (0.15, 0.6, 0.2, 1.5, 1.5, 1.8)))
    cam = make_camera(pos=(0.15, 0.3, 0.15), target=(0.6, 0.1, 0.6), aspect=width / height)
    cfg = RenderConfig(width=width, height=height, mode="whitted",
                       max_bounces=3 if glass else 5, activate_sky=False,
                       deterministic_lights=True, whitted_glass_split=True)
    return _assemble(vols, mats, lights, cam), cfg


def monu_path(width=1920, height=1080, gridsize=64, which=(1, 2, 3), bounces=4, spp=1):
    """Config 4 (presets.py:90-110): monu1-3.vox side by side on a floor
    slab, path traced under the procedural sky."""
    updates: dict = {}
    specs = [VolumeSpec(position=(float(i) * 0.75 - 0.75, 0.0, 0.0), gridsize=gridsize,
                        grid=_load_grid(f"monu{m}.vox", gridsize, updates))
             for i, m in enumerate(which)]
    specs.append(VolumeSpec(position=(0.0, -0.51, 0.0), gridsize=1,
                            scale=(8.0, 0.02, 8.0), grid=solid_grid(1, 7)))
    mats = apply_palette_updates(default_materials(), updates)
    lights = make_lights(point=((0.0, 3.0, -2.0, 6.0, 6.0, 6.0),))
    cam = make_camera(pos=(0.1, 1.1, -2.6), target=(0.2, 0.5, 0.5), aspect=width / height)
    cfg = RenderConfig(width=width, height=height, mode="path", max_bounces=bounces,
                       spp=spp, activate_sky=True)
    return _assemble(build_volumes(specs), mats, lights, cam), cfg


def city_path(width=1920, height=1080, gridsize=64, nx=4, nz=4, bounces=4,
              spp=1, vary_scale=False, page=24):
    """Config 5 (presets.py:113-143): an nx x nz grid of the
    SmallBuilding01/02 and TallBuilding01 models, each at a random quarter
    turn (and with vary_scale a scale in [0.7, 1.3)) drawn from
    ``default_rng(7)``, on a floor slab; past 64 volumes the set is
    paginated."""
    updates: dict = {}
    names = ["SmallBuilding01.vox", "SmallBuilding02.vox", "TallBuilding01.vox"]
    grids = [_load_grid(n, gridsize, updates) for n in names]
    mats = apply_palette_updates(default_materials(), updates)
    specs = []
    rng = np.random.default_rng(7)
    for ix in range(nx):
        for iz in range(nz):
            g = grids[int(rng.integers(0, len(grids)))]
            s = float(rng.uniform(0.7, 1.3)) if vary_scale else 1.0
            specs.append(VolumeSpec(
                position=(ix * 0.6 - nx * 0.3, 0.0, iz * 0.6 - nz * 0.3),
                gridsize=gridsize, grid=g, scale=(s, s, s),
                rotation=(0.0, float(rng.integers(0, 4)) * np.pi / 2.0, 0.0)))
    specs.append(VolumeSpec(position=(0.0, -0.51, 0.0), gridsize=1,
                            scale=(12.0, 0.02, 12.0), grid=solid_grid(1, 0)))
    vols = build_volumes(specs)
    if len(specs) > 64:
        vols = paginate_volumes(vols, page=page)
    lights = make_lights(point=((0.0, 5.0, -4.0, 20.0, 20.0, 18.0),))
    cam = make_camera(pos=(-1.5, 1.6, -3.2), target=(0.0, 0.3, 0.0), aspect=width / height)
    cfg = RenderConfig(width=width, height=height, mode="path", max_bounces=bounces,
                       spp=spp, activate_sky=True)
    return _assemble(vols, mats, lights, cam), cfg


def city_xl_path(width=1920, height=1080, gridsize=64, bounces=4, spp=1):
    """Config 5 at its blueprint scale (presets.py:146-161): city_path on
    an 11 x 10 grid with varied scales, 110 buildings and the floor = 111
    volumes, paginated, under a pulled-back camera."""
    scene, cfg = city_path(width=width, height=height, gridsize=gridsize, nx=11, nz=10,
                           bounces=bounces, spp=spp, vary_scale=True)
    cam = make_camera(pos=(-3.4, 2.6, -5.6), target=(0.0, 0.2, 0.0), aspect=width / height)
    return dataclasses.replace(scene, camera=cam), cfg


def monu_like_specs(gridsize=64, seeds=(1, 2, 3)) -> list:
    """monu_path's volumes (presets.py:96-102) with noise grids in place of
    monu1-3.vox: three volumes side by side, then the floor slab."""
    specs = [VolumeSpec(position=(float(i) * 0.75 - 0.75, 0.0, 0.0),
                        gridsize=gridsize, grid=generate_noise_grid(gridsize, seed=s))
             for i, s in enumerate(seeds)]
    specs.append(VolumeSpec(position=(0.0, -0.51, 0.0), gridsize=1,
                            scale=(8.0, 0.02, 8.0), grid=solid_grid(1, 7)))
    return specs


def monu_like_path(width=1920, height=1080, gridsize=64, bounces=4, seeds=(1, 2, 3), spp=1):
    """The bench scene without assets: monu's light and camera
    (presets.py:105-106), the procedural sky, 4-bounce path tracing.
    seeds: one noise model per seed (monu_path's `which`)."""
    vols = build_volumes(monu_like_specs(gridsize, seeds))
    lights = make_lights(point=((0.0, 3.0, -2.0, 6.0, 6.0, 6.0),))
    cam = make_camera(pos=(0.1, 1.1, -2.6), target=(0.2, 0.5, 0.5),
                      aspect=width / height)
    scene = _assemble(vols, default_materials(), lights, cam)
    cfg = RenderConfig(width=width, height=height, mode="path",
                       max_bounces=bounces, spp=spp, activate_sky=True)
    return scene, cfg


def glass_box_specs() -> list:
    """glass_sphere_box's volumes (presets.py:172-180): a rotated glass
    block, a red floor and a mirror wall."""
    return [
        VolumeSpec(position=(0, 0, 0), gridsize=8, grid=solid_grid(8, GLASS),
                   scale=(0.5, 0.5, 0.5), rotation=(0.13, 0.41, 0.07)),
        VolumeSpec(position=(0.0, -0.6, 0.0), gridsize=1, scale=(4.0, 0.3, 4.0),
                   grid=solid_grid(1, 1), rotation=(0.02, 0.11, 0.015)),
        VolumeSpec(position=(0.0, 0.0, 0.8), gridsize=1, scale=(3.0, 3.0, 0.2),
                   grid=solid_grid(1, 7), rotation=(0.06, -0.09, 0.03)),
    ]


def _glass_box_view(width, height):
    lights = make_lights(point=((0.83, 1.57, -1.21, 2.0, 2.0, 2.0),))
    cam = make_camera(pos=(0.517, 0.703, -1.59), target=(0.49, 0.41, 0.5),
                      aspect=width / height)
    return lights, cam


def glass_sphere_box(width=64, height=64):
    """The small deterministic dielectric scene (presets.py:164-188),
    rendered whitted at depth 5 with the all-lights NEE sum: it takes
    every whitted branch, the glass block's exit march included."""
    lights, cam = _glass_box_view(width, height)
    scene = _assemble(build_volumes(glass_box_specs()), default_materials(),
                      lights, cam)
    cfg = RenderConfig(width=width, height=height, mode="whitted", max_bounces=5,
                       activate_sky=False, deterministic_lights=True)
    return scene, cfg


def media_specs(smoke_gridsize=32) -> list:
    """The glass box plus one smoke volume to the right of the glass block."""
    return glass_box_specs() + [
        VolumeSpec(position=(0.3, -0.05, 0.0), gridsize=smoke_gridsize,
                   grid=generate_smoke_grid(smoke_gridsize, seed=5),
                   scale=(0.45, 0.45, 0.45), rotation=(0.0, 0.2, 0.0)),
    ]


def media_path(width=256, height=256, bounces=4):
    """Glass and smoke in one path-traced frame: rays enter the glass
    block and the smoke volume, so the exit march runs."""
    lights, cam = _glass_box_view(width, height)
    scene = _assemble(build_volumes(media_specs()), default_materials(),
                      lights, cam)
    cfg = RenderConfig(width=width, height=height, mode="path",
                       max_bounces=bounces, activate_sky=True)
    return scene, cfg


def city_like_specs(gridsize=64, nx=11, nz=10, vary_scale=True, seeds=(11, 12, 13)) -> list:
    """city_path's volumes (presets.py:113-133) with three noise grids in
    place of its three building models: an nx x nz grid of buildings at
    0.6 spacing, each a random model at a random quarter turn (and, with
    vary_scale, a scale in [0.7, 1.3)), drawn as there from
    ``default_rng(7)``; then the 12 x 0.02 x 12 floor slab."""
    grids = [generate_noise_grid(gridsize, seed=s) for s in seeds]
    specs = []
    rng = np.random.default_rng(7)
    for ix in range(nx):
        for iz in range(nz):
            g = grids[int(rng.integers(0, len(grids)))]
            s = float(rng.uniform(0.7, 1.3)) if vary_scale else 1.0
            specs.append(VolumeSpec(
                position=(ix * 0.6 - nx * 0.3, 0.0, iz * 0.6 - nz * 0.3),
                gridsize=gridsize, grid=g, scale=(s, s, s),
                rotation=(0.0, float(rng.integers(0, 4)) * np.pi / 2.0, 0.0)))
    specs.append(VolumeSpec(position=(0.0, -0.51, 0.0), gridsize=1,
                            scale=(12.0, 0.02, 12.0), grid=solid_grid(1, 0)))
    return specs


def city_xl_like_path(width=1920, height=1080, gridsize=64, bounces=4, page=24, spp=1):
    """The 111-volume city scene's layout without its assets: 110
    procedural buildings plus the floor, paginated (5 pages of at most 24
    volumes, morton order), under city_path's light (presets.py:139) and
    city_xl_path's pulled-back camera (presets.py:159), 4-bounce path
    tracing."""
    vols = paginate_volumes(build_volumes(city_like_specs(gridsize)), page=page)
    lights = make_lights(point=((0.0, 5.0, -4.0, 20.0, 20.0, 18.0),))
    cam = make_camera(pos=(-3.4, 2.6, -5.6), target=(0.0, 0.2, 0.0), aspect=width / height)
    scene = _assemble(vols, default_materials(), lights, cam)
    cfg = RenderConfig(width=width, height=height, mode="path",
                       max_bounces=bounces, spp=spp, activate_sky=True)
    return scene, cfg


PRESETS = {
    "teapot": teapot_primary,
    "room": room_whitted,
    "roomglass": functools.partial(room_whitted, glass=True),
    "monu": monu_path,
    "city": city_path,
    "cityxl": city_xl_path,
    "glassbox": glass_sphere_box,
    "monu_like": monu_like_path,
    "media": media_path,
    "city_xl_like": city_xl_like_path,
}
