"""The plain reference of the benchmark: plain PyTorch and numpy, importing
neither JAX, the JAX package nor anything of ``voxtracer_torch``.

A frozen copy of the port's plain path (its pure-torch route, which runs
wherever CUDA kernels are absent) from commit 86df7ae of the repository,
module for module, with imports rewritten to this package:
``config``, ``core/{mathx,rng,sampling,transforms,types}``,
``kernels/{dda,dda_occ,primitives}``,
``render/{camera,integrator,reproject,sky,tonemap}``,
``diff/{train,volumetric}``, ``scene/{instances,lights,materials,procgen,volume}``
and ``io/hdr``.  Changed from the copy:

* ``kernels/traverse.py``: no kernels; the walks of the (volume, ray)
  pairs whose ray enters the cube, merged by t (earliest volume on a tie);
* ``kernels/lookup.py``: no kernels; the adjoint sums each entry's rows
  sorted, in float64, with no atomics;
* ``scene/instances.py``: the uniform-brick table in numpy (no native
  builder); ``scene/volume.py``: no ``.vox`` ingest;
* ``render/integrator._pages``: None (the traversal culls per pair);
* ``diff/volumetric._REMAT``: a constant (the stored march).
"""
