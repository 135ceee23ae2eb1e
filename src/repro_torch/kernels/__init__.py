"""Kernels of the port.

* ``triad_census.census_tiles`` — the census tile kernel, hand-written in
  CUDA C++ for Hopper (``csrc/census_tiles.cu``), built with ``nvcc`` at
  first use (:mod:`repro_torch.kernels._build`);
* ``ref.census_tiles_ref`` — its plain torch version (the CPU path and
  the reference on the card);
* ``flash_attention.flash_attention`` — causal GQA flash attention,
  hand-written in CUDA C++ for Hopper (``csrc/flash_attention.cu``);
* ``ref.flash_attention_ref`` — its plain torch version;
* ``ops`` — the front doors: ``flash_attention``, and the transpose CSR and
  the six neighbourhood tiles the census kernel reads.
"""
from . import flash_attention, ops, ref, triad_census  # noqa: F401
