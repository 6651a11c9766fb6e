"""Differentiable rendering: the relaxed transmittance march and its
trainer (counterpart of voxtracer/diff/volumetric.py)."""
