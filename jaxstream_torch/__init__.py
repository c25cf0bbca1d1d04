"""jaxstream_torch: the PyTorch/CUDA port of :mod:`jaxstream`.

A second implementation of the cubed-sphere shallow-water framework,
written against PyTorch and hand-written CUDA kernels for NVIDIA Hopper
(``sm_90a``).  It imports ``torch`` and numpy only; the JAX package is
the reference it is tested against, never a runtime dependency.

Module names mirror the JAX package's, so each counterpart is one path
away: ``jaxstream/geometry/cubed_sphere.py`` <->
``jaxstream_torch/geometry/cubed_sphere.py``, and the Pallas TPU kernels
of ``jaxstream/ops/pallas/`` become the CUDA kernels wrapped in
``jaxstream_torch/ops/cuda/`` (sources under ``csrc/``).

Entry points (:func:`~jaxstream_torch.geometry.cubed_sphere.build_grid`,
the initial conditions, the models) run on the GPU unless the caller
asks for the CPU with ``device="cpu"``; without a GPU they raise rather
than fall back.
"""
