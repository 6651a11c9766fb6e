"""Light bank builder (Renderer::SetUpLights, renderer.cpp:93-100;
counterpart of voxtracer/scene/lights.py)."""

from __future__ import annotations

import numpy as np
import torch

from voxtracer_torch.core.types import Lights


def make_lights(
    point=((0.5, 0.5, 3.5, 1.0, 1.0, 1.0),),
    spot=(),
    area=(),
    directional=((1.0, 0.0, 0.0), (0.0, 0.0, 0.0)),
) -> Lights:
    """point: (px,py,pz, r,g,b); spot: (px,py,pz, dx,dy,dz, r,g,b, cos_angle);
    area: (px,py,pz, r,g,b, mult, radius); directional: (direction, color),
    always present (renderer.cpp:2295)."""
    point = np.asarray(point, np.float32).reshape(-1, 6)
    spot = np.asarray(spot, np.float32).reshape(-1, 10)
    area = np.asarray(area, np.float32).reshape(-1, 8)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a))

    return Lights(
        point_pos=t(point[:, 0:3]), point_color=t(point[:, 3:6]),
        spot_pos=t(spot[:, 0:3]), spot_dir=t(spot[:, 3:6]),
        spot_color=t(spot[:, 6:9]), spot_cos_angle=t(spot[:, 9]),
        area_pos=t(area[:, 0:3]), area_color=t(area[:, 3:6]),
        area_mult=t(area[:, 6]), area_radius=t(area[:, 7]),
        dir_direction=t(np.asarray(directional[0], np.float32)),
        dir_color=t(np.asarray(directional[1], np.float32)),
    )
