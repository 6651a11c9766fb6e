"""Asset-free scene presets (counterpart of voxtracer/scene/presets.py).

Each builder returns ``(Scene, RenderConfig)`` with CPU tensors; move the
scene with ``scene.to(device)``.

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

import numpy as np
import torch

from voxtracer_torch.config import RenderConfig
from voxtracer_torch.core.types import GLASS, Scene, Sky
from voxtracer_torch.io.hdr import procedural_sky
from voxtracer_torch.render.camera import make_camera
from voxtracer_torch.scene.instances import (VolumeSpec, build_volumes,
                                             make_spheres, make_triangles,
                                             paginate_volumes)
from voxtracer_torch.scene.lights import make_lights
from voxtracer_torch.scene.materials import default_materials
from voxtracer_torch.scene.procgen import (generate_noise_grid,
                                           generate_smoke_grid)
from voxtracer_torch.scene.volume import solid_grid


def _sky(width=512, height=256, contribution=1.0) -> Sky:
    return Sky(pixels=torch.from_numpy(procedural_sky(width, height)),
               contribution=torch.tensor(contribution, dtype=torch.float32))


def _assemble(volumes, materials, lights, camera, sky=None) -> Scene:
    return Scene(volumes=volumes, materials=materials, lights=lights,
                 spheres=make_spheres(), triangles=make_triangles(),
                 sky=sky if sky is not None else _sky(), camera=camera)


def monu_like_specs(gridsize=64, seeds=(1, 2, 3)) -> list:
    """monu_path's volumes (presets.py:96-102) with noise grids in place of
    monu1-3.vox: three volumes side by side, then the floor slab."""
    specs = [VolumeSpec(position=(float(i) * 0.75 - 0.75, 0.0, 0.0),
                        gridsize=gridsize, grid=generate_noise_grid(gridsize, seed=s))
             for i, s in enumerate(seeds)]
    specs.append(VolumeSpec(position=(0.0, -0.51, 0.0), gridsize=1,
                            scale=(8.0, 0.02, 8.0), grid=solid_grid(1, 7)))
    return specs


def monu_like_path(width=1920, height=1080, gridsize=64, bounces=4, seeds=(1, 2, 3)):
    """The bench scene without assets: monu's light and camera
    (presets.py:105-106), the procedural sky, 4-bounce path tracing.
    seeds: one noise model per seed (monu_path's `which`)."""
    vols = build_volumes(monu_like_specs(gridsize, seeds))
    lights = make_lights(point=((0.0, 3.0, -2.0, 6.0, 6.0, 6.0),))
    cam = make_camera(pos=(0.1, 1.1, -2.6), target=(0.2, 0.5, 0.5),
                      aspect=width / height)
    scene = _assemble(vols, default_materials(), lights, cam)
    cfg = RenderConfig(width=width, height=height, mode="path",
                       max_bounces=bounces, activate_sky=True)
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


def city_xl_like_path(width=1920, height=1080, gridsize=64, bounces=4, page=24):
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
                       max_bounces=bounces, activate_sky=True)
    return scene, cfg


PRESETS = {
    "monu_like": monu_like_path,
    "glassbox": glass_sphere_box,
    "media": media_path,
    "city_xl_like": city_xl_like_path,
}
