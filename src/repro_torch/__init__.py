"""PyTorch/CUDA port of the triad-census engine.

The same algorithm as the JAX package ``repro``, run with torch on an
NVIDIA GPU: :mod:`repro_torch.core` (graphs, generators, mutations, the
census building blocks and the brute-force oracle),
:mod:`repro_torch.kernels` (the hand-written CUDA kernels and their plain
torch versions), :mod:`repro_torch.engine` (the ``compile(...).run(g)``
front door: fused ops, batches and deltas) and :mod:`repro_torch.serve`
(the census service and the LM serving steps).
It imports neither ``jax`` nor ``repro``.
"""
