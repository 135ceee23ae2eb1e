"""Declarative parameter tables: one table drives init and the weight layout.

Counterpart of :mod:`repro.models.params`.  ``ParamDef`` describes shape,
logical axes and initializer of every weight; params live in a flat dict
``{"path/like/this": tensor}`` with the JAX package's keys and shapes
(per-layer stacks carry a leading ``L`` dim, :func:`stacked`), so a table
from either package names the same weights.
:func:`repro_torch.models.convert.from_jax_params` turns such a dict into
the port's modules.  :func:`param_specs` maps the same table through the
sharding rules (:mod:`repro_torch.sharding.rules`), so init and placement
cannot drift; :func:`abstract_params` gives the table's tensors on the
``meta`` device (shapes and dtypes, no storage).
"""
from __future__ import annotations

import math
from typing import TYPE_CHECKING, NamedTuple

import numpy as np
import torch

if TYPE_CHECKING:
    from ..sharding.rules import Rules


class ParamDef(NamedTuple):
    shape: tuple
    logical: tuple  # logical axis name per dim (see sharding.rules)
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


def iter_init_params(defs: dict[str, ParamDef], generator: torch.Generator,
                     dtype=torch.float32):
    """``(path, index, tensor)`` of every param in the order they are
    drawn: path by path in sorted order from the one generator, a
    ``layers`` stack one slice at a time (``index`` its place in the
    stack, None for an unstacked def).  Draws straight in ``dtype`` (a
    bf16 model is never built in f32 first), on ``generator``'s device.
    The same std rule as JAX (``1/sqrt(fan_in)`` of the whole def's shape,
    or the def's ``scale``); the numbers differ from ``jax.random``'s, so
    parity tests hand both packages one numpy draw instead.  A caller
    that places each slice before taking the next (a sharded init) holds
    one slice of one def at most."""
    dev = generator.device
    for path in sorted(defs):
        d = defs[path]
        fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
        std = d.scale if d.scale is not None else 1.0 / math.sqrt(
            max(fan_in, 1))
        stack = d.logical[:1] == ("layers",)
        shape = d.shape[1:] if stack else d.shape
        for i in range(d.shape[0]) if stack else (None,):
            if d.init == "zeros":
                val = torch.zeros(shape, dtype=dtype, device=dev)
            elif d.init == "ones":
                val = torch.ones(shape, dtype=dtype, device=dev)
            else:
                val = torch.randn(shape, generator=generator, dtype=dtype,
                                  device=dev).mul_(std)
            yield path, i, val


def init_params(defs: dict[str, ParamDef], generator: torch.Generator,
                dtype=torch.float32) -> dict[str, torch.Tensor]:
    """Materialize every param on ``generator``'s device, in ``dtype``: the
    slices of :func:`iter_init_params`, each stack written into its
    tensor, so a seed fixes every weight."""
    params = {}
    for path, i, val in iter_init_params(defs, generator, dtype):
        if i is None:
            params[path] = val
        else:
            if i == 0:
                params[path] = val.new_empty(defs[path].shape)
            params[path][i] = val
    return params


def param_specs(defs: dict[str, ParamDef], rules: "Rules") -> dict:
    """``{path: spec}``: each def's logical axes through ``rules`` (a
    tuple of mesh-axis names, tuples of names or None per dim)."""
    return {path: rules.spec(d.logical) for path, d in defs.items()}


def abstract_params(defs: dict[str, ParamDef],
                    dtype=torch.float32) -> dict[str, torch.Tensor]:
    """Every def as a ``meta`` tensor of its shape in ``dtype``: JAX's
    ``ShapeDtypeStruct`` table, nothing allocated."""
    return {p: torch.empty(d.shape, dtype=dtype, device="meta")
            for p, d in defs.items()}


def count_params(defs: dict[str, ParamDef]) -> int:
    return int(sum(np.prod(d.shape) for d in defs.values()))
