"""Scene records: plain dataclasses of tensors (counterpart of
voxtracer/core/types.py, without flax).

Every record has ``.to(device)``; the device a scene lives on is the device
the integrators and kernels run on.  Material tables have 256 entries;
entry 255 is the empty/NONE slot.
"""

from __future__ import annotations

from dataclasses import dataclass, fields, replace

import torch

MAT_NONE = 255

# Material class ranges (reference enum, scene.h:38-57)
NON_METAL_WHITE = 0
NON_METAL_RED = 1
NON_METAL_BLUE = 2
NON_METAL_GREEN = 3
NON_METAL_PINK = 4
METAL_HIGH = 5
METAL_MID = 6
METAL_LOW = 7
GLASS = 8
SMOKE_LOW_DENSITY = 9
SMOKE_LOW2_DENSITY = 10
SMOKE_MID_DENSITY = 11
SMOKE_MID2_DENSITY = 12
SMOKE_HIGH_DENSITY = 13
SMOKE_PLAYER = 14
EMISSIVE = 15

# occupancy predicate planes of VoxVolumes.occ
OCC_ANY = 0          # cell != MAT_NONE            (nearest / occluded)
OCC_EXIT_GLASS = 1   # cell != GLASS               (FindMaterialExit leave)
OCC_EXIT_SMOKE = 2   # cell outside smoke range    (FindSmokeExit leave)


class _Record:
    """``to(device)`` for a dataclass whose fields are tensors or records."""

    def to(self, device):
        def move(x):
            if isinstance(x, (torch.Tensor, _Record)):
                return x.to(device)
            return x

        return replace(self, **{f.name: move(getattr(self, f.name))
                                for f in fields(self)})


@dataclass
class Materials(_Record):
    albedo: torch.Tensor     # [256, 3] f32
    roughness: torch.Tensor  # [256] f32
    emissive: torch.Tensor   # [256] f32
    ior: torch.Tensor        # [256] f32


@dataclass
class Lights(_Record):
    """All light banks; the single directional light always exists
    (renderer.cpp:2290-2296 counts it unconditionally)."""

    point_pos: torch.Tensor       # [P, 3]
    point_color: torch.Tensor     # [P, 3]
    spot_pos: torch.Tensor        # [S, 3]
    spot_dir: torch.Tensor        # [S, 3]
    spot_color: torch.Tensor      # [S, 3]
    spot_cos_angle: torch.Tensor  # [S]
    area_pos: torch.Tensor        # [A, 3]
    area_color: torch.Tensor      # [A, 3]
    area_mult: torch.Tensor       # [A]
    area_radius: torch.Tensor     # [A]
    dir_direction: torch.Tensor   # [3]
    dir_color: torch.Tensor       # [3]

    @property
    def n_point(self) -> int:
        return self.point_pos.shape[0]

    @property
    def n_spot(self) -> int:
        return self.spot_pos.shape[0]

    @property
    def n_area(self) -> int:
        return self.area_pos.shape[0]

    @property
    def count(self) -> int:
        return self.n_point + self.n_spot + self.n_area + 1


@dataclass
class Spheres(_Record):
    center: torch.Tensor    # [M, 3]
    radius: torch.Tensor    # [M]
    material: torch.Tensor  # [M] i32


@dataclass
class Triangles(_Record):
    v0: torch.Tensor        # [M, 3]
    v1: torch.Tensor        # [M, 3]
    v2: torch.Tensor        # [M, 3]
    position: torch.Tensor  # [M, 3]
    material: torch.Tensor  # [M] i32


@dataclass
class VoxVolumes(_Record):
    """Batched voxel-volume instances, padded to one cube size G.

    Object space is the unit cube [cube_min, cube_min + 1]; ``inv`` takes
    rays world -> object, ``fwd`` normals object -> world.  ``occ`` holds
    one 512-bit row (16 int32 words, LSB first, bit (fx*8+fy)*8+fz) per
    8^3 brick for each of the three OCC_* predicate planes.

    ``pages`` (scene/instances.paginate_volumes) splits a large set into
    child records of a few volumes each, every one a slice
    ``[vol_off, vol_off + n)`` of this record's arrays, in the order a
    paged traversal walks them; ``to(device)`` cuts the pages out of the
    moved arrays again, so they share the parent's memory (``occ`` apart:
    its slice is not contiguous)."""

    grids: torch.Tensor      # [V, G, G, G] i32 material ids
    gridsize: torch.Tensor   # [V] i32 logical size (1..G)
    inv: torch.Tensor        # [V, 4, 4] f32 world -> object
    fwd: torch.Tensor        # [V, 4, 4] f32 object -> world
    cube_min: torch.Tensor   # [V, 3] f32
    bricks: torch.Tensor     # [V, M, M, M] i32 uniform value or -1
    bricksize: torch.Tensor  # [V] i32 ceil(gridsize / 8)
    occ: torch.Tensor        # [3, V, M^3, 16] i32
    pages: tuple | None = None  # child VoxVolumes in walk order, or None
    vol_off: int = 0         # a page's first volume in its parent

    @property
    def n(self) -> int:
        return self.grids.shape[0]

    def page(self, lo: int, hi: int) -> "VoxVolumes":
        """Volumes [lo, hi) as a page: views of this record's arrays and a
        contiguous copy of their occupancy rows."""
        return VoxVolumes(
            grids=self.grids[lo:hi], gridsize=self.gridsize[lo:hi], inv=self.inv[lo:hi],
            fwd=self.fwd[lo:hi], cube_min=self.cube_min[lo:hi], bricks=self.bricks[lo:hi],
            bricksize=self.bricksize[lo:hi], occ=self.occ[:, lo:hi].contiguous(), vol_off=lo)

    def with_pages(self, bounds) -> "VoxVolumes":
        """This record with pages cut at bounds, (lo, hi) pairs in walk order."""
        return replace(self, pages=tuple(self.page(lo, hi) for lo, hi in bounds))

    def to(self, device):
        moved = _Record.to(replace(self, pages=None), device)
        if self.pages is None:
            return moved
        return moved.with_pages([(p.vol_off, p.vol_off + p.n) for p in self.pages])

    @property
    def pad_size(self) -> int:
        """G, the padded cube edge of every grid."""
        return self.grids.shape[1]


@dataclass
class Sky(_Record):
    pixels: torch.Tensor        # [H, W, 3] f32 equirect dome
    contribution: torch.Tensor  # scalar f32


@dataclass
class Camera(_Record):
    pos: torch.Tensor
    top_left: torch.Tensor
    top_right: torch.Tensor
    bottom_left: torch.Tensor
    right: torch.Tensor
    up: torch.Tensor
    ahead: torch.Tensor
    focal_distance: torch.Tensor  # scalar
    defocus_jitter: torch.Tensor  # scalar


@dataclass
class Scene(_Record):
    """The complete world handed to the integrators."""

    volumes: VoxVolumes
    materials: Materials
    lights: Lights
    spheres: Spheres
    triangles: Triangles
    sky: Sky
    camera: Camera

    @property
    def device(self) -> torch.device:
        return self.volumes.grids.device
