"""Kernels of the port.

* ``triad_census.census_tiles`` — the census tile kernel, hand-written in
  CUDA C++ for Hopper (``csrc/census_tiles.cu``), built with ``nvcc`` at
  first use (:mod:`repro_torch.kernels._build`);
* ``ref.census_tiles_ref`` — its plain torch version (the CPU path and
  the reference on the card);
* ``ops`` — the transpose CSR and the six neighbourhood tiles it reads.
"""
from . import ops, ref, triad_census  # noqa: F401
