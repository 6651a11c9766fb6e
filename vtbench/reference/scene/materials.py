"""Default material bank (Renderer::MaterialSetUp, renderer.cpp:357-443;
counterpart of voxtracer/scene/materials.py).  Slots 16..254 are pad
materials, which the ``.vox`` palette mutates; slot 255 is NONE."""

from __future__ import annotations

from dataclasses import replace

import numpy as np
import torch

from vtbench.reference.core.types import Materials


def default_materials() -> Materials:
    albedo = np.ones((256, 3), np.float32)
    roughness = np.ones(256, np.float32)
    emissive = np.zeros(256, np.float32)
    ior = np.full(256, 1.5, np.float32)
    smoke_color = np.array([1.0, 0.7, 1.0], np.float32)
    # non-metals 0-4 (renderer.cpp:360-364)
    albedo[0] = (1, 1, 1); roughness[0] = 1.0
    albedo[1] = (1, 0, 0); roughness[1] = 0.6
    albedo[2] = (0, 0, 1); roughness[2] = 0.25
    albedo[3] = (0, 1, 0); roughness[3] = 0.0
    albedo[4] = (1, 0.6, 0.8); roughness[4] = 0.3
    # metals 5-7 (renderer.cpp:367-369)
    albedo[5] = (1, 1, 1); roughness[5] = 1.0
    albedo[6] = (0, 1, 1); roughness[6] = 0.5
    albedo[7] = (0.9, 0.9, 0.9); roughness[7] = 0.01
    # glass 8 (renderer.cpp:371-372)
    albedo[8] = (1, 0.5, 1); roughness[8] = 1.0; ior[8] = 1.45
    # smoke 9-14 (renderer.cpp:375-399)
    for i, strength in zip(range(9, 14), (3.0, 8.0, 12.0, 15.0, 16.0)):
        albedo[i] = smoke_color
        ior[i] = 1.0
        emissive[i] = strength
    albedo[14] = (0, 0, 0); ior[14] = 1.0; emissive[14] = 22.0  # SMOKE_PLAYER
    # emissive 15 (renderer.cpp:401-402)
    albedo[15] = smoke_color; emissive[15] = 5.0
    # 255: NONE, zeroed so an accidental lookup contributes nothing
    albedo[255] = 0; roughness[255] = 0; emissive[255] = 0; ior[255] = 1.0
    t = torch.from_numpy
    return Materials(albedo=t(albedo), roughness=t(roughness),
                     emissive=t(emissive), ior=t(ior))


def apply_palette_updates(materials: Materials, updates: dict[int, np.ndarray]) -> Materials:
    """LoadModel's material-table mutation (scene.cpp:516-520): albedo from
    the palette, roughness 1, in the dict's order (the last load wins)."""
    albedo, roughness = materials.albedo.clone(), materials.roughness.clone()
    for idx, rgb in updates.items():
        albedo[idx] = torch.as_tensor(np.asarray(rgb, np.float32), device=albedo.device)
        roughness[idx] = 1.0
    return replace(materials, albedo=albedo, roughness=roughness)


def randomize_smoke_colors(materials: Materials, rng: np.random.Generator) -> Materials:
    """RandomizeSmokeColors (renderer.cpp:348-355): smoke rows 9-13 drawn
    around (1, 0.7, 1) from rng, three draws a row in the JAX package's
    order."""
    albedo = materials.albedo.clone()
    base = np.array([1.0, 0.7, 1.0], np.float32)
    for i in range(9, 14):  # SMOKE_LOW..SMOKE_HIGH
        row = base + np.array([rng.uniform(-0.2, 0.0), rng.uniform(-0.2, 0.2),
                               rng.uniform(-0.1, 0.0)], np.float32)
        albedo[i] = torch.from_numpy(row).to(albedo.device)
    return replace(materials, albedo=albedo)
