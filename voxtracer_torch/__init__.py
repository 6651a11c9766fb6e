"""voxtracer_torch — the PyTorch/CUDA port of voxtracer.

Same module layout as the JAX package (``core/``, ``scene/``, ``kernels/``,
``render/``, ``io/``, ``config.py``, ``cli.py``).  Plain tensor code is
PyTorch; the traversal and row-lookup kernels are hand-written CUDA C++
for Hopper (``csrc/``), built with nvcc at first use.  The device is
whatever device the scene's tensors live on: CUDA tensors go through the
kernels, CPU tensors through each kernel's plain PyTorch version.
"""
