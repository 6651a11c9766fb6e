"""Interactive live viewer (counterpart of voxtracer/viewer.py): the
analogue of the reference's GLFW window, fly camera and ImGui edit loop
(template.cpp:296-329, camera.h:113-181, renderer.cpp:2348-2971).

The "surface" is the terminal: frames draw as ANSI truecolor half-blocks
(one character cell = two stacked pixels).  Input is raw non-blocking
keyboard reads (termios + select): WASD/QE fly, arrow keys look, the
reference key map.  Any camera move or live material edit resets the
progressive accumulator, the rule of every ImGui callback in the reference
(renderer.cpp:343).  A scripted mode (a `script` of per-frame key sets,
display off) drives the same loop headlessly, without a TTY.

A frame is ``render`` (through the kernels on a CUDA scene), the running
mean with weight 1 / (n + 1) and the tonemap to uint8, on the scene's
device; one uint8 image a frame comes to the host.  An edit builds new
material or light tensors and leaves the volumes as they are, so the
kernels' packed volume tables (cached on the volumes' tensors) are kept.
"""

from __future__ import annotations

import dataclasses
import io
import sys
import time

import numpy as np
import torch

from voxtracer_torch.core.rng import fold_in, make_key
from voxtracer_torch.render.accumulate import accumulate
from voxtracer_torch.render.flycam import FlyState, handle_input, to_camera
from voxtracer_torch.render.integrator import render
from voxtracer_torch.render.tonemap import to_rgb8
from voxtracer_torch.utils.profiling import FrameReport


# ---------------------------------------------------------------- terminal IO

class KeyReader:
    """Non-blocking raw keyboard input.  Terminals deliver key *presses*
    (no key-up), so each frame consumes all pending bytes and treats them
    as that frame's held-key set."""

    ARROWS = {"A": "up", "B": "down", "C": "right", "D": "left"}

    def __init__(self):
        import termios
        import tty

        self.fd = sys.stdin.fileno()
        self.saved = termios.tcgetattr(self.fd)
        tty.setcbreak(self.fd)

    def close(self):
        import termios

        termios.tcsetattr(self.fd, termios.TCSADRAIN, self.saved)

    def poll(self) -> set:
        import select

        keys = set()
        while select.select([sys.stdin], [], [], 0)[0]:
            ch = sys.stdin.read(1)
            if ch == "\x1b":  # escape sequence (arrow) or bare ESC
                if select.select([sys.stdin], [], [], 0)[0]:
                    seq = sys.stdin.read(1)
                    if seq == "[" and select.select([sys.stdin], [], [], 0)[0]:
                        keys.add(self.ARROWS.get(sys.stdin.read(1), "esc"))
                else:
                    keys.add("esc")
            elif ch:
                keys.add(ch.lower())
        return keys


class TermDisplay:
    """ANSI truecolor half-block framebuffer (2 pixels per text row),
    written to `out` (the terminal unless the caller passes a stream)."""

    def __init__(self, out=None):
        self.out = sys.stdout if out is None else out
        self.out.write("\x1b[?1049h\x1b[?25l")  # alt screen, hide cursor

    def close(self):
        self.out.write("\x1b[?25h\x1b[?1049l")
        self.out.flush()

    # 3-digit ASCII LUT: byte value -> b"000".."255" (leading zeros are
    # valid ANSI parameter syntax, making every cell a FIXED 41 bytes)
    _DIG = np.frombuffer(b"".join(b"%03d" % i for i in range(256)),
                         np.uint8).reshape(256, 3)
    _CELL = np.frombuffer(b"\x1b[38;2;000;000;000m"
                          b"\x1b[48;2;000;000;000m\xe2\x96\x80", np.uint8)
    _SLOTS = (7, 11, 15, 26, 30, 34)  # RRR GGG BBB (fg), RRR GGG BBB (bg)

    def show(self, rgb8: np.ndarray, status: str):
        # every cell is a constant 41 bytes, so the frame is one fancy-index
        # fill of a cached byte template, not a per-pixel Python loop
        h, w, _ = rgb8.shape
        hh = h // 2
        tmpl_key = (hh, w)
        if getattr(self, "_tmpl_key", None) != tmpl_key:
            suffix = np.frombuffer(b"\x1b[0m\x1b[K\n", np.uint8)
            row_len = w * len(self._CELL) + len(suffix)
            buf = np.empty((hh, row_len), np.uint8)
            buf[:, :w * len(self._CELL)] = np.tile(self._CELL, (1, w))
            buf[:, w * len(self._CELL):] = suffix
            self._buf = buf
            self._tmpl_key = tmpl_key
        cells = self._buf[:, :w * len(self._CELL)].reshape(
            hh, w, len(self._CELL))
        comp = np.concatenate([rgb8[0:2 * hh:2], rgb8[1:2 * hh:2]],
                              axis=-1)  # [hh, w, 6]
        for slot, ch in zip(self._SLOTS, range(6)):
            cells[:, :, slot:slot + 3] = self._DIG[comp[..., ch]]
        self.out.write("\x1b[H"
                       + self._buf.tobytes().decode("utf-8")
                       + "\x1b[0m" + status + "\x1b[K")
        self.out.flush()


# ----------------------------------------------------------------- live edits

class EditState:
    """Live edit cursor, the ImGui panel analogue (renderer.cpp:2348-2971:
    every scene parameter tweakable at runtime, each edit resetting the
    accumulator) as a terminal keymap:

      0-9          pick material slot directly; [ / ] step slot -/+
      m / n        albedo of the slot  x1.25 / x0.8
      r / f        roughness           +0.1 / -0.1   (clamped 0..1)
      g / h        emissive strength   +0.5 / -0.5   (clamped >= 0)
      i / k        IOR                 +0.05 / -0.05 (clamped >= 1)
      l            cycle the selected light (point -> area -> spot -> dir)
      u / j        selected light's color x1.25 / x0.8
    """

    def __init__(self, material: int = 6, light: int = 0):
        self.material = material
        self.light = light

    def status(self, scene) -> str:
        m = scene.materials
        i = self.material
        alb = m.albedo[i].cpu().numpy()
        return (f"mat {i}: alb=({alb[0]:.2f},{alb[1]:.2f},{alb[2]:.2f}) "
                f"rough={float(m.roughness[i]):.2f} "
                f"emis={float(m.emissive[i]):.2f} "
                f"ior={float(m.ior[i]):.2f} light#{self.light}")


def _set_row(t, i, value):
    """A copy of t with row i replaced; t itself is left as it is."""
    out = t.clone()
    out[i] = value
    return out


def apply_edits(scene, keys, edit: EditState):
    """Apply this frame's edit keys -> (scene, edited?).  A function of
    the pressed-key set that builds new tensors and never writes into the
    caller's scene; shared by the live loop and the headless tests."""
    edited = False
    for ch in keys & set("0123456789"):
        edit.material = int(ch)
    if "[" in keys:
        edit.material = (edit.material - 1) % 256
    if "]" in keys:
        edit.material = (edit.material + 1) % 256
    i = edit.material
    m = scene.materials

    def upd(**kw):
        nonlocal m, edited
        m = dataclasses.replace(m, **kw)
        edited = True

    if "m" in keys:
        upd(albedo=_set_row(m.albedo, i, m.albedo[i] * 1.25))
    if "n" in keys:
        upd(albedo=_set_row(m.albedo, i, m.albedo[i] * 0.8))
    if "r" in keys:
        upd(roughness=_set_row(m.roughness, i, torch.clamp(m.roughness[i] + 0.1, 0.0, 1.0)))
    if "f" in keys:
        upd(roughness=_set_row(m.roughness, i, torch.clamp(m.roughness[i] - 0.1, 0.0, 1.0)))
    if "g" in keys:
        upd(emissive=_set_row(m.emissive, i, m.emissive[i] + 0.5))
    if "h" in keys:
        upd(emissive=_set_row(m.emissive, i, torch.clamp(m.emissive[i] - 0.5, min=0.0)))
    if "i" in keys:
        upd(ior=_set_row(m.ior, i, m.ior[i] + 0.05))
    if "k" in keys:
        upd(ior=_set_row(m.ior, i, torch.clamp(m.ior[i] - 0.05, min=1.0)))
    if edited:
        scene = dataclasses.replace(scene, materials=m)

    L = scene.lights
    if "l" in keys:
        edit.light = (edit.light + 1) % max(L.count, 1)
    if "u" in keys or "j" in keys:
        s = 1.25 if "u" in keys else 0.8
        li = edit.light
        if li < L.n_point:
            L = dataclasses.replace(L, point_color=_set_row(L.point_color, li,
                                                            L.point_color[li] * s))
        elif li < L.n_point + L.n_area:
            j = li - L.n_point
            L = dataclasses.replace(L, area_color=_set_row(L.area_color, j, L.area_color[j] * s))
        elif li < L.n_point + L.n_area + L.n_spot:
            j = li - L.n_point - L.n_area
            L = dataclasses.replace(L, spot_color=_set_row(L.spot_color, j, L.spot_color[j] * s))
        else:
            L = dataclasses.replace(L, dir_color=L.dir_color * s)
        scene = dataclasses.replace(scene, lights=L)
        edited = True
    return scene, edited


# ------------------------------------------------------------------ live loop

def live_step(scene, cfg, acc, n_frames: int, key, spp: int):
    """One frame: render a sample -> the running mean with weight
    1 / (n_frames + 1) -> Reinhard-Jodie -> uint8 -> (acc, rgb8), both on
    the scene's device."""
    acc = accumulate(acc, render(scene, cfg, key, spp), n_frames)
    return acc, to_rgb8(acc)


class LiveSession:
    """The live loop's state: the scene with its edits, the fly pose, the
    edit cursor, the accumulator and its frame count.  ``frame(keys,
    dt_ms)`` runs one frame of ``run_live``."""

    def __init__(self, scene, cfg, spp: int = 1, seed: int = 0, edit_material: int = 6):
        self.scene, self.cfg, self.spp = scene, cfg, spp
        self.fly = FlyState.from_camera(scene.camera)
        self.edit = EditState(material=edit_material)
        self.aspect = cfg.width / cfg.height
        self.acc = torch.zeros((cfg.height, cfg.width, 3), dtype=torch.float32,
                               device=scene.device)
        self.n_acc = 0
        self.frames = 0
        self.key = make_key(seed)

    def frame(self, keys: set, dt_ms: float) -> np.ndarray:
        """Apply the keys, render and accumulate frame `frames` under
        ``fold_in(key, frames)`` -> the tonemapped image on the host."""
        self.scene, edited = apply_edits(self.scene, keys, self.edit)
        moved = handle_input(self.fly, keys, dt_ms, slow="shift" in keys)
        if moved:
            self.scene = dataclasses.replace(
                self.scene, camera=to_camera(self.fly, self.aspect, self.scene.camera))
        if moved or edited:
            self.n_acc = 0  # ResetAccumulator (renderer.cpp:343): weight 1 overwrites acc
        self.acc, rgb = live_step(self.scene, self.cfg, self.acc, self.n_acc,
                                  fold_in(self.key, self.frames), self.spp)
        self.n_acc += 1
        self.frames += 1
        return rgb.cpu().numpy()


def run_live(scene, cfg, *, max_frames: int = 0, script=None,
             display: bool = True, spp: int = 1, seed: int = 0,
             edit_material: int = 6):
    """The frame loop (template.cpp:296-329 analogue) on the scene's
    device.  script: optional iterable of per-frame key sets (headless
    driving); when given and display is False, no TTY is needed.  Returns
    (frames_rendered, report) for the caller/tests."""
    live = LiveSession(scene, cfg, spp, seed, edit_material)
    # per-frame stats go to the HUD line, not stderr, when displaying
    report = FrameReport(cfg.width, cfg.height,
                         stream=io.StringIO() if display else sys.stderr)
    reader = disp = None
    if display:
        disp = TermDisplay()
        if script is None:
            reader = KeyReader()
    script_it = iter(script) if script is not None else None

    dt_ms = 33.0
    try:
        while True:
            if max_frames and live.frames >= max_frames:
                break
            t0 = time.time()
            if script_it is not None:
                try:
                    keys = set(next(script_it))
                except StopIteration:
                    break
            elif reader is not None:
                keys = reader.poll()
            else:
                keys = set()
            if "esc" in keys or "x" in keys:
                break
            rgb = live.frame(keys, dt_ms)
            dt = time.time() - t0
            dt_ms = dt * 1000.0
            if not display:
                print(f"raw {dt_ms:.1f} ms keys={sorted(keys)}",
                      file=sys.stderr, flush=True)
            stats = report.frame(dt)
            if disp is not None:
                fly = live.fly
                disp.show(rgb, f"{stats['ms']:.1f}ms ({stats['fps']:.1f}fps) "
                               f"{stats['mrays_s']:.2f}Mrays/s  "
                               f"spp={live.n_acc} "
                               f"pos=({fly.pos[0]:.1f},{fly.pos[1]:.1f},"
                               f"{fly.pos[2]:.1f})  {live.edit.status(live.scene)}  "
                               f"[wasd/qe/arrows move, 0-9/[/] slot, "
                               f"m/n r/f g/h i/k edit, l u/j lights, "
                               f"x quit]")
    finally:
        if reader is not None:
            reader.close()
        if disp is not None:
            disp.close()
    return live.frames, report
