"""Levels, zones and the game loop's state (counterpart of
voxtracer/game/level.py), the reference's level scripting on the host:
  SetUpFirstZone        renderer.cpp:592-657
  CreateBridge          renderer.cpp:482-529
  CreateBridgeBlind     renderer.cpp:531-590
  SetUpSecondZone       renderer.cpp:1904-1967
  chunk progression, light kill, win state   renderer.cpp:2103-2204

The Game owns VolumeSpec lists and the light, sphere and triangle banks,
all numpy, built and edited as the JAX package's (every draw from
``self.rng`` in its order), and builds the port's Scene on a device when
dirty (every edit resets the accumulator, renderer.cpp:343-346)."""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np

from voxtracer_torch.core.types import (EMISSIVE, GLASS, METAL_HIGH, METAL_LOW,
                                        METAL_MID, Scene)
from voxtracer_torch.game.player import PlayerCharacter
from voxtracer_torch.game.props import ModifyingProp
from voxtracer_torch.io.vox import load_vox
from voxtracer_torch.render.camera import make_camera
from voxtracer_torch.scene import presets
from voxtracer_torch.scene.instances import (VolumeSpec, build_volumes,
                                             make_spheres, make_triangles)
from voxtracer_torch.scene.lights import default_spot, make_lights
from voxtracer_torch.scene.materials import (apply_palette_updates,
                                             default_materials,
                                             randomize_smoke_colors)
from voxtracer_torch.scene.procgen import generate_smoke_grid
from voxtracer_torch.scene.volume import grid_from_vox, solid_grid

CHUNK_SIZES = (10, 14, 9)  # dataChunks, renderer.h:213


def _rand_mat(rng, lo, hi):
    """static_cast<MatType>(Rand(lo, hi)) — float cast truncation quirk."""
    return int(rng.uniform(lo, hi))


@dataclass
class GameState:
    current_chunk: int = 0
    trigger_checkpoint: float = -17.0
    in_light: bool = False
    won: bool = False
    win_timer: float = 0.0
    static_camera: bool = False
    static_camera_timer: float = 0.0
    time_to_reactivate: float = 2.0


class Game:
    """The playable scene graph + progression logic."""

    def __init__(self, seed: int = 0, asset_dir: str | None = None):
        self.rng = np.random.default_rng(seed)
        self.assets = asset_dir or presets.ASSET_DIR
        self.state = GameState()
        self.player = PlayerCharacter()
        self.materials = default_materials()
        self.mat_updates: dict = {}
        self.volumes: list[VolumeSpec] = []
        self.spheres: list = []
        self.triangles: list = []
        self.point_lights = [(0.5, 0.5, 3.5, 1.0, 1.0, 1.0)]
        self.spot_lights = [list(default_spot()) for _ in range(5)]
        self.area_lights: list = []
        self.props: list[ModifyingProp | None] = [None, None]
        self.dirty = True
        self.cam_pos = np.array([0.0, 0.0, -2.0], np.float32)
        self.cam_target = np.array([0.0, 0.0, -1.0], np.float32)
        self._setup_first_zone()
        # initial player placement (renderer.cpp:734-735)
        pos, rot = self.player.move((0, 0, 0), (0, 1, 0))
        self.volumes[0].position = tuple(pos)
        self.volumes[0].rot_mat4 = rot
        self.player.snapshot(self.volumes[0].position)

    # ------------------------------------------------------------------
    # construction (zones & bridges)
    # ------------------------------------------------------------------
    def _load(self, name, gridsize, random_smoke=False):
        model = load_vox(os.path.join(self.assets, name))
        if random_smoke:
            # LoadModelRandomMaterials: Rand(SMOKE_MID2, SMOKE_HIGH) per
            # voxel truncates to 12 nearly always (scene.cpp:661-662)
            return grid_from_vox(model, gridsize,
                                 material_override=lambda: _rand_mat(self.rng, 12, 13))
        return grid_from_vox(model, gridsize, material_updates=self.mat_updates)

    def _setup_first_zone(self):
        rng = self.rng
        # triangle pattern (renderer.cpp:460-469)
        tri_pos = np.array([-1.75, 0.0, 3.0], np.float32)
        scale = 0.25
        for _ in range(10):
            m = _rand_mat(rng, 0, METAL_LOW)
            v0 = np.array([0, 0, 0], np.float32)
            v1 = np.array([scale * 2, 0, 0], np.float32)
            v2 = np.array([scale, scale * 2, 0], np.float32)
            self.triangles.append((v0, v1, v2, tri_pos.copy(), m))
            tri_pos[0] += scale * 2

        vs = self.volumes
        vs.append(VolumeSpec(position=(0, 0, 0), gridsize=16,
                             grid=self._load("player.vox", 16)))
        vs.append(VolumeSpec(position=(0.0, -1.0, 0.0), gridsize=1,
                             scale=(5.0, 1.0, 5.0), grid=solid_grid(1, METAL_LOW)))
        vs.append(VolumeSpec(position=(6.0, 0.0, 0.0), gridsize=1,
                             scale=(5.0, 5.0, 5.0), grid=solid_grid(1, METAL_LOW)))
        vs.append(VolumeSpec(position=(-10.0, 2.0, 0.0), gridsize=1,
                             scale=(5.0, 5.0, 5.0), grid=solid_grid(1, METAL_LOW)))
        vs.append(VolumeSpec(position=(0.0, 4.0, 0.0), gridsize=1,
                             scale=(10.0, 1.0, 10.0), grid=solid_grid(1, METAL_LOW)))
        self.materials = randomize_smoke_colors(self.materials, rng)
        vs.append(VolumeSpec(position=(0.0, 0.3, 0.0), gridsize=64,
                             scale=(3.0, 3.0, 3.0),
                             grid=generate_smoke_grid(64, 0.167,
                                                      int(rng.integers(1 << 30)))))
        vs.append(VolumeSpec(position=(0.0, 3.0, -3.0), gridsize=32,
                             scale=(5.0, 5.0, 5.0),
                             grid=self._load("Text.vox", 32, random_smoke=True)))
        self._create_bridge((0.0, 0.0, 0.0))
        # spotlight placement (renderer.cpp:638-655)
        for i in range(len(self.spot_lights)):
            if i >= 2:
                self.spot_lights[i][0:3] = [-3.0, float(np.sin(i)) + 1.0,
                                            -25.0 - i * 2.0]
                self.spot_lights[i][3:6] = [1.0, 0.0, 0.0]
                self.spot_lights[i][9] = float(np.cos(np.deg2rad(rng.uniform(20, 45))))
                u = rng.random()
                self.spot_lights[i][6:9] = [1.0 - u, rng.random(), rng.random()]
            else:
                self.spot_lights[i][0:3] = [0.0, 0.0, -22.0 - i * 3.0]
                self.spot_lights[i][3:6] = [0.0, 1.0, 0.0]
        self._create_bridge_blind((0.0, 0.0, -17.0), (0.0, -6.0, 0.0), GLASS)
        self.dirty = True

    def _create_bridge(self, offset, enter_offset=(0, 0, 0), door_material=None):
        """CreateBridge (renderer.cpp:482-529)."""
        rng = self.rng
        off = np.asarray(offset, np.float32)
        ent = np.asarray(enter_offset, np.float32)
        parts = [
            VolumeSpec(position=tuple(np.array([0.0, 4.0, -7.0]) + off + ent),
                       gridsize=1, scale=(10.0, 1.0, 5.0)),
            VolumeSpec(position=tuple(np.array([-1.0, 0.0, -11.0]) + off),
                       gridsize=1, scale=(3.0, 10.0, 1.0),
                       grid=solid_grid(1, door_material if door_material is not None
                                       else _rand_mat(rng, 0, 4))),
            VolumeSpec(position=tuple(np.array([-5.0, 1.0, -12.0]) + off),
                       gridsize=1, scale=(2.0, 3.0, 10.0)),
            VolumeSpec(position=tuple(np.array([-3.0, 1.0, -19.0]) + off),
                       gridsize=1, scale=(7.0, 1.0, 1.0)),
            VolumeSpec(position=tuple(np.array([0.0, -1.0, -18.0]) + off),
                       gridsize=1, scale=(5.0, 1.0, 5.0),
                       grid=solid_grid(1, _rand_mat(rng, METAL_HIGH, GLASS))),
            VolumeSpec(position=tuple(np.array([0.0, 0.3, -17.0]) + off),
                       gridsize=64, scale=(2.0, 2.0, 2.0)),  # checkpoint, empty
        ]
        for i in (0, 2, 3):
            parts[i].grid = solid_grid(1, _rand_mat(rng, 0, 4))
        self.volumes.extend(parts)

    def _create_bridge_blind(self, offset, enter_offset=(0, 0, 0),
                             door_material=None):
        """CreateBridgeBlind (renderer.cpp:531-590)."""
        rng = self.rng
        off = np.asarray(offset, np.float32)
        ent = np.asarray(enter_offset, np.float32)
        mk = lambda p, g=1: VolumeSpec(position=tuple(p), gridsize=g)
        parts = [
            mk(np.array([0.0, 4.0, -7.0]) + off + ent),
            mk(np.array([-1.0, 0.0, -11.0]) + off),
            mk(np.array([5.0, -41.0, -12.0]) + off),
            mk(np.array([-5.0, 1.0, -12.0]) + off),
            mk(np.array([3.0, 51.0, -19.0]) + off),
            mk(np.array([-3.0, 1.0, -19.0]) + off),
            mk(np.array([0.0, -1.0, -18.0]) + off),
            mk(np.array([0.0, 0.3, -17.0]) + off, 64),
        ]
        parts[0].scale = (10.0, 1.0, 5.0)
        parts[1].scale = (3.0, 10.0, 1.0)
        parts[1].grid = solid_grid(1, door_material if door_material is not None
                                   else _rand_mat(rng, 0, 4))
        for i in range(7):
            if i in (1, 3):
                continue
            parts[i].grid = solid_grid(1, _rand_mat(rng, 0, 4))
        parts[2].scale = (2.0, 3.0, 10.0)
        parts[2].grid = solid_grid(1, METAL_LOW)
        parts[3].scale = (2.0, 3.0, 10.0)
        parts[4].scale = (7.0, 1.0, 1.0)
        parts[4].grid = solid_grid(1, _rand_mat(rng, METAL_HIGH, GLASS))
        parts[5].scale = (7.0, 1.0, 1.0)
        parts[6].scale = (5.0, 1.0, 5.0)
        parts[7].scale = (2.0, 2.0, 2.0)
        parts[7].grid = None  # checkpoint, NONE
        self.volumes.extend(parts)

    def _setup_second_zone(self):
        """SetUpSecondZone (renderer.cpp:1904-1967)."""
        rng = self.rng
        tc = self.state.trigger_checkpoint
        if len(self.volumes) > 3:
            self.volumes[3].grid = generate_smoke_grid(
                64, 0.167, int(rng.integers(1 << 30)))
            self.volumes[3].gridsize = 64
        self._create_bridge_blind((0.0, 0.0, tc))
        off = np.array([-3.0, 0.0, tc - 24.0], np.float32)
        ent = np.array([0.0, -6.0, 0.0], np.float32)
        parts = [
            VolumeSpec(position=tuple(np.array([0.0, 4.0, -7.0]) + off + ent),
                       gridsize=1, scale=(15.0, 1.0, 20.0),
                       grid=solid_grid(1, _rand_mat(rng, 0, 4))),
            VolumeSpec(position=tuple(off + np.array([0.0, 0.0, -10.0])),
                       gridsize=1, scale=(5.0, 10.0, 1.0),
                       grid=solid_grid(1, METAL_MID)),
            VolumeSpec(position=tuple(off + np.array([3.0, 0.0, 0.0])),
                       gridsize=1, scale=(2.0, 3.0, 2.0),
                       rotation=(0.0, np.pi / 4, 0.0),
                       grid=solid_grid(1, METAL_HIGH)),
            VolumeSpec(position=tuple(off), gridsize=64, scale=(5.0, 5.0, 5.0),
                       grid=self._load("monu2.vox", 64)),
            VolumeSpec(position=tuple(off + np.array([2.0, 0.0, -4.0])),
                       gridsize=64, scale=(7.5, 5.0, 5.0),
                       rotation=(0.0, np.pi / 2, 0.0),
                       grid=self._load("monu2.vox", 64)),
        ]
        self.volumes.extend(parts)
        self.spheres.append((*(np.array([0.0, 5.0, -5.0]) + off), 0.6, EMISSIVE))
        self.area_lights = [(*(np.array([-1.0, 1.0, -5.0]) + off), 1.0, 1.0, 1.0,
                             1.0, 1.2)]
        self.point_lights = [(*(np.array([-1.0, 1.0, -5.0]) + off), 1.0, 1.0, 1.0)]

    # ------------------------------------------------------------------
    # per-frame logic (Tick game section, renderer.cpp:2103-2204)
    # ------------------------------------------------------------------
    def tick(self, dt: float, keydir: str | None, find_nearest_player,
             revert_key: bool = False, in_light: bool | None = None):
        """One game step.  `find_nearest_player(o, d, dist)` -> (vol_idx, t,
        point, normal) traces against all volumes but 0, smoke filtered
        (FindNearestPlayer semantics).

        `in_light` is the renderer's light-kill observation for the frame
        just drawn (render_game_frame aux, renderer.cpp:1437-1450); it ORs
        into the state flag consumed by the checkpoint revert below
        (renderer.cpp:2112-2118)."""
        st = self.state
        if in_light is not None:
            st.in_light = st.in_light or bool(in_light)
        if st.static_camera:
            st.static_camera_timer += dt
            if st.static_camera_timer > st.time_to_reactivate:
                st.static_camera = False
        if st.in_light or revert_key:
            pos, rot = self.player.revert()
            self.volumes[0].position = tuple(pos)
            self.volumes[0].rot_mat4 = rot
            st.static_camera = True
            st.static_camera_timer = 0.0
            self.dirty = True
        if st.current_chunk >= 3:
            st.win_timer += dt
            if st.win_timer > 5.0:
                st.won = True
        if st.current_chunk < 3:
            for i, prop in enumerate(self.props):
                if prop is None:
                    continue
                grid = prop.update(dt)
                if grid is not None:
                    vol = self.volumes[len(self.volumes) - 1 - i]
                    vol.grid = grid
                    vol.gridsize = grid.shape[0]
                    self.dirty = True

        if self.player.update_input(keydir):
            o, d, dist = self.player.probe_ray()
            vol_idx, t, point, normal = find_nearest_player(o, d, dist)
            if vol_idx > 0 and t < dist:
                self.cam_pos = np.array([self.cam_pos[0], self.cam_pos[1],
                                         o[2] + 5.0], np.float32)
                self.cam_target = np.asarray(point, np.float32)
                pos, rot = self.player.move(point, normal)
                self.volumes[0].position = tuple(pos)
                self.volumes[0].rot_mat4 = rot
                if point[2] < st.trigger_checkpoint and point[1] < 0.5:
                    self._advance_chunk(point, o)
                self.dirty = True
        st.in_light = False

    def _advance_chunk(self, point, probe_origin):
        st = self.state
        self.materials = randomize_smoke_colors(self.materials, self.rng)
        st.trigger_checkpoint -= 17.0
        if st.current_chunk < 2:
            del self.volumes[1:CHUNK_SIZES[st.current_chunk]]
        st.current_chunk += 1
        self.triangles.clear()
        if st.current_chunk == 1:
            self._setup_second_zone()
            st.trigger_checkpoint = -52.0
        elif st.current_chunk == 2:
            for i in range(len(self.props)):
                vol = self.volumes[len(self.volumes) - 1 - i]
                self.props[i] = ModifyingProp(
                    os.path.join(self.assets, "monu2.vox"), vol.gridsize,
                    period=0.9, starting_index=16, increase_rate=16)
            if len(self.volumes) > 6:
                self.volumes[6].grid = generate_smoke_grid(
                    64, 0.167, int(self.rng.integers(1 << 30)))
                self.volumes[6].gridsize = 64
            st.trigger_checkpoint = -71.0
        elif st.current_chunk == 3:
            last_pos = np.array([0.0, 3.0, -75.0], np.float32)
            st.win_timer = 0.0
            self.cam_target = last_pos
            pos, rot = self.player.move(last_pos, (0.0, 1.0, 0.0))
            self.volumes[0].position = tuple(pos)
            self.volumes[0].rot_mat4 = rot
            win = VolumeSpec(position=tuple(last_pos), gridsize=32,
                             scale=(10.0, 10.0, 10.0),
                             grid=self._load("textWin.vox", 32, random_smoke=True))
            self.volumes.append(win)
        self.player.snapshot(self.volumes[0].position)

    # ------------------------------------------------------------------
    def build_scene(self, width=256, height=212, device="cuda") -> Scene:
        """The port's Scene of the game as it stands, on `device` (call when
        .dirty; a new scene resets the accumulator)."""
        mats = apply_palette_updates(self.materials, self.mat_updates)
        self.dirty = False
        return Scene(
            volumes=build_volumes(self.volumes),
            materials=mats,
            lights=make_lights(point=self.point_lights,
                               spot=[tuple(s) for s in self.spot_lights],
                               area=self.area_lights),
            spheres=make_spheres(self.spheres),
            triangles=make_triangles(self.triangles),
            sky=presets._sky(),
            camera=make_camera(pos=tuple(self.cam_pos),
                               target=tuple(self.cam_target),
                               aspect=width / height),
        ).to(device)
