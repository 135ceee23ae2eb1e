"""Declarative parameter tables: one table drives init and the weight layout.

Counterpart of :mod:`repro.models.params`.  ``ParamDef`` describes shape,
logical axes and initializer of every weight; params live in a flat dict
``{"path/like/this": tensor}`` with the JAX package's keys and shapes
(per-layer stacks carry a leading ``L`` dim, :func:`stacked`), so a table
from either package names the same weights.
:func:`repro_torch.models.convert.from_jax_params` turns such a dict into
the port's modules.  The logical axes are kept for the multi-GPU slice;
sharding specs (``param_specs``, ``Rules``) wait for it.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch


class ParamDef(NamedTuple):
    shape: tuple
    logical: tuple  # logical axis name per dim (sharding waits)
    init: str = "normal"  # normal | zeros | ones | embed
    scale: float | None = None  # stddev override


def stacked(defs: dict[str, ParamDef], n: int,
            prefix: str = "") -> dict[str, ParamDef]:
    """Prepend a layer-stack dim to every def."""
    return {prefix + k: ParamDef((n, *d.shape), ("layers", *d.logical),
                                 d.init, d.scale)
            for k, d in defs.items()}


def prefixed(defs: dict[str, ParamDef], prefix: str) -> dict[str, ParamDef]:
    return {prefix + k: v for k, v in defs.items()}


def init_params(defs: dict[str, ParamDef], generator: torch.Generator,
                dtype=torch.float32) -> dict[str, torch.Tensor]:
    """Materialize every param on ``generator``'s device, in ``dtype``.

    Draws straight in ``dtype`` (a bf16 model is never built in f32
    first), path by path in sorted order from the one generator, so a seed
    fixes every weight.  The same std rule as JAX (``1/sqrt(fan_in)``, or
    the def's ``scale``); the numbers differ from ``jax.random``'s, so
    parity tests hand both packages one numpy draw instead.
    """
    dev = generator.device
    params = {}
    for path in sorted(defs):
        d = defs[path]
        if d.init == "zeros":
            params[path] = torch.zeros(d.shape, dtype=dtype, device=dev)
        elif d.init == "ones":
            params[path] = torch.ones(d.shape, dtype=dtype, device=dev)
        else:
            fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
            std = d.scale if d.scale is not None else 1.0 / math.sqrt(
                max(fan_in, 1))
            params[path] = torch.randn(d.shape, generator=generator,
                                       dtype=dtype, device=dev).mul_(std)
    return params


def count_params(defs: dict[str, ParamDef]) -> int:
    return int(sum(np.prod(d.shape) for d in defs.values()))
