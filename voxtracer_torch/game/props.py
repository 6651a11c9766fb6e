"""Animated props (counterpart of voxtracer/game/props.py; reference:
src/Game/ModifyingProp.{h,cpp}): every `period` seconds a sliding column
window of a model (monu2.vox in the game) is reloaded into the prop's
volume (LoadModelPartial, scene.cpp:531-604)."""

from __future__ import annotations

import numpy as np

from voxtracer_torch.io.vox import load_vox
from voxtracer_torch.scene.volume import grid_from_vox


class ModifyingProp:
    def __init__(self, model_path: str, gridsize: int, period: float = 0.9,
                 starting_index: int = 13, increase_rate: int = 13,
                 max_index: int = 64):
        self.model = load_vox(model_path)
        self.gridsize = gridsize
        self.period = period
        self.index = starting_index
        self.rate = increase_rate
        self.max_index = max_index
        self._elapsed = 0.0
        self._changed = False

    def update(self, dt: float) -> np.ndarray | None:
        """Advance time by dt; a fresh grid when the window slides
        (ModifyingProp::Update, ModifyingProp.cpp:11-22), else None."""
        self._elapsed += dt
        self._changed = False
        if self._elapsed < self.period:
            return None
        self._elapsed = 0.0
        self._changed = True
        grid = grid_from_vox(self.model, self.gridsize,
                             column_window=(self.index, self.rate))
        self.index += self.rate
        if self.index > self.max_index:
            self.index = self.rate
        return grid

    @property
    def changed(self) -> bool:
        return self._changed
