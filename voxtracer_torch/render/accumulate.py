"""Progressive accumulation (counterpart of voxtracer/render/accumulate.py;
reference: renderer.cpp:1646-1828 — ``acc = lerp(acc, new, 1/(N+1))``
running mean, reset on any edit)."""

from __future__ import annotations

import torch


def accumulate(acc, new, num_rendered_frames: int):
    """One progressive-refinement step; returns the updated accumulator.
    num_rendered_frames is the count BEFORE this frame (reference weight,
    renderer.cpp:1651).  The weight is computed in float32, as in JAX."""
    n = torch.tensor(num_rendered_frames, dtype=torch.float32, device=acc.device)
    w = 1.0 / (n + 1.0)
    return acc * (1.0 - w) + new * w


class ProgressiveState:
    """Host-side epoch counter + device accumulator (ResetAccumulator
    analogue, renderer.cpp:343-346), on the card unless the caller asks
    for another device."""

    def __init__(self, height: int, width: int, device="cuda"):
        self.acc = torch.zeros((height, width, 3), dtype=torch.float32, device=device)
        self.frames = 0

    def add(self, frame):
        self.acc = accumulate(self.acc, frame, self.frames)
        self.frames += 1
        return self.acc

    def reset(self):
        self.acc = torch.zeros_like(self.acc)
        self.frames = 0
