"""Kernels of the port.

* ``triad_census.census_csr`` — the census main path's kernel, which
  reads each dyad's CSR rows directly, hand-written in CUDA C++ for
  Hopper (``csrc/census_csr.cu``), built with ``nvcc`` at first use
  (:mod:`repro_torch.kernels._build`); ``ref.census_csr_ref`` is its
  plain torch version (the CPU path and the reference on the card);
* ``triad_census.census_tiles`` — the six-tile census kernel
  (``csrc/census_tiles.cu``), the counterpart of the Pallas kernel's
  interface, off the main path; ``ref.census_tiles_ref`` is its plain
  version;
* ``flash_attention.flash_attention`` — causal GQA flash attention,
  hand-written in CUDA C++ for Hopper (``csrc/flash_attention.cu``);
* ``ref.flash_attention_ref`` — its plain torch version;
* ``ops`` — the front doors: ``flash_attention``, the arc flags and range
  counts the CSR census kernel reads, and the transpose CSR and six
  neighbourhood tiles the six-tile kernel reads.
"""
from . import flash_attention, ops, ref, triad_census  # noqa: F401
