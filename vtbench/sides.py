"""The two sides a run compares: the program (``voxtracer_torch``) and the
plain reference (``vtbench.reference``), which has the same module layout
and functions.  The benchmark makes the inputs (the grids, the sky) from
the configuration and hands the same to both; each side builds its own
scene from them (volume tables, pages, materials, lights, camera)."""

from __future__ import annotations

import importlib
from dataclasses import dataclass

import numpy as np
import torch

from vtbench.reference.io.hdr import procedural_sky
from vtbench.reference.scene.procgen import generate_noise_grid, generate_smoke_grid

PROGRAM = "voxtracer_torch"
REFERENCE = "vtbench.reference"


class Side:
    """One side's modules, by their dotted names under its root."""

    def __init__(self, root: str):
        self.root = root

    def mod(self, name: str):
        """The module ``<root>.<name>``, such as ``render.integrator``."""
        return importlib.import_module(f"{self.root}.{name}")


@dataclass
class Inputs:
    grids: dict          # grid name -> [g, g, g] uint8 numpy
    sky: np.ndarray      # [H, W, 3] f32


def make_inputs(conf: dict) -> Inputs:
    """The grids and the sky a configuration names, made by the benchmark."""
    grids = {}
    for name, g in conf["grids"].items():
        size = g["gridsize"]
        if g["kind"] == "noise":
            grids[name] = generate_noise_grid(size, frequency=g["frequency"], seed=g["seed"])
        elif g["kind"] == "smoke":
            grids[name] = generate_smoke_grid(size, frequency=g["frequency"], seed=g["seed"])
        elif g["kind"] == "solid":
            grids[name] = np.full((size,) * 3, g["material"], np.uint8)
        else:
            raise ValueError(f"grid {name!r}: unknown kind {g['kind']!r}")
    sky = conf["sky"]
    if sky["kind"] != "procedural":
        raise ValueError(f"unknown sky kind {sky['kind']!r}")
    return Inputs(grids=grids, sky=procedural_sky(sky["width"], sky["height"]))


def has_media(inputs: Inputs) -> bool:
    """Whether any grid holds glass or smoke (cells 8-14): only then does
    a path frame march through a medium (K3)."""
    return any(bool(((g >= 8) & (g <= 14)).any()) for g in inputs.grids.values())


def make_scene(side: Side, conf: dict, inputs: Inputs, device, **render):
    """(scene on `device`, RenderConfig) of one side; `render` overrides
    fields of the configuration's render settings."""
    inst = side.mod("scene.instances")
    types = side.mod("core.types")
    specs = [inst.VolumeSpec(position=tuple(v["position"]),
                             gridsize=conf["grids"][v["grid"]]["gridsize"],
                             scale=tuple(v.get("scale", (1.0, 1.0, 1.0))),
                             rotation=tuple(v.get("rotation", (0.0, 0.0, 0.0))),
                             grid=inputs.grids[v["grid"]])
             for v in conf["volumes"]]
    vols = inst.build_volumes(specs)
    if conf.get("page"):
        vols = inst.paginate_volumes(vols, page=conf["page"])
    cfg = side.mod("config").RenderConfig(**{**conf["render"], **render})
    cam = conf["camera"]
    sky = conf["sky"]
    scene = types.Scene(
        volumes=vols, materials=side.mod("scene.materials").default_materials(),
        lights=side.mod("scene.lights").make_lights(point=tuple(tuple(p) for p in conf["lights"]["point"])),
        spheres=inst.make_spheres(), triangles=inst.make_triangles(),
        sky=types.Sky(pixels=torch.from_numpy(inputs.sky.copy()),
                           contribution=torch.tensor(sky["contribution"], dtype=torch.float32)),
        camera=side.mod("render.camera").make_camera(pos=tuple(cam["pos"]), target=tuple(cam["target"]),
                                       aspect=cfg.width / cfg.height))
    return scene.to(device), cfg
