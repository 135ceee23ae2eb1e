"""PyTorch/CUDA port of the triad-census engine.

The same algorithm as the JAX package ``repro``, run with torch on an
NVIDIA GPU: :mod:`repro_torch.core` (graphs, generators, the census
building blocks and the brute-force oracle), :mod:`repro_torch.kernels`
(the hand-written CUDA census tile kernel and its plain torch version),
and :mod:`repro_torch.engine` (the ``compile(...).run(g)`` front door).
It imports neither ``jax`` nor ``repro``.
"""
