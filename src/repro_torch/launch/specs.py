"""Dry-run cell construction: (arch × shape × mesh shape) -> the step's
state on the ``meta`` device and its placements.

Counterpart of :mod:`repro.launch.specs`.  :func:`build_cell` gives, for
any architecture and input shape, the model's parameters (and for a
train cell the gradients and both f32 moments), the batch and, for a
decode cell, the cache, each as ``meta`` tensors (nothing allocated),
with each tensor's spec from the logical rule table.  The mesh is a
shape (``{"data": 16, "model": 16}``): the rule table reads only axis
names, and no process group of that size has to exist.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Optional

import torch

from ..config import SHAPES, ModelConfig, RunConfig, ShapeConfig, get_config
from ..models import transformer as tfm
from ..models.params import abstract_params, param_specs
from ..sharding.rules import axis_sizes, batch_axes, make_rules


class SkipCell(Exception):
    """Raised when an (arch, shape) cell does not apply (JAX's rule)."""


@dataclasses.dataclass
class Cell:
    arch: str
    shape: ShapeConfig
    cfg: ModelConfig
    run: RunConfig
    #: ``{group: {name: meta tensor}}``: "params", and "grads", "m", "v"
    #: (train), "batch", "cache" (decode, a flat dict of its leaves)
    state: dict
    #: the same structure as ``state``: each tensor's spec
    specs: dict
    meta: dict


def _model_axis(mesh: Mapping) -> int:
    return axis_sizes(mesh)["model"]


def _batch_shards(mesh: Mapping) -> int:
    sizes = axis_sizes(mesh)
    return math.prod(sizes[a] for a in batch_axes(mesh))


def default_run(arch: str, shape: ShapeConfig) -> RunConfig:
    """Baseline run settings per cell (JAX's), with the port's flash
    kernel as the attention."""
    big = arch in ("deepseek-coder-33b", "deepseek-v2-236b", "pixtral-12b")
    micro = None
    if shape.kind == "train":
        micro = 8 if big else 4
    return RunConfig(
        attention_impl="flash",
        attention_chunk=1024,
        remat="full" if shape.kind == "train" else "none",
        microbatch=micro,
        act_shard_model=big and shape.kind == "train",
    )


def applicable(cfg: ModelConfig, shape: ShapeConfig) -> "tuple[bool, str]":
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, ("pure full-attention arch: long_500k requires "
                       "sub-quadratic attention (DESIGN.md shape-skip note)")
    return True, ""


def make_cell_rules(cfg: ModelConfig, shape: ShapeConfig, mesh,
                    run: RunConfig):
    ma = _model_axis(mesh)
    bs = _batch_shards(mesh)
    return make_rules(
        mesh,
        fsdp_axis=run.fsdp_axis,
        expert_sharding=("expert" if cfg.moe and cfg.moe.n_experts % ma == 0
                         else "tensor"),
        batch_shardable=shape.global_batch % bs == 0,
        seq_shard_kv=(shape.kind == "decode" and shape.global_batch % bs != 0
                      and run.seq_shard_decode),
        vocab_shardable=cfg.vocab_size % ma == 0,
        act_shard_model=run.act_shard_model,
    )


def serve_rules(cfg: ModelConfig, run: RunConfig, mesh, batch: int,
                max_seq: int):
    """The rules of a serving run of ``batch`` requests over a
    ``max_seq``-slot cache on ``mesh``: :func:`make_cell_rules` of that
    decode cell, so the batch shards when it divides the batch shards,
    and otherwise, under ``run.seq_shard_decode``, the attention caches'
    sequence does (JAX's rule for its decode cells).  The model, its
    cache (:func:`~repro_torch.models.transformer.init_cache`) and the
    serving steps all take these."""
    return make_cell_rules(cfg, ShapeConfig("serve", "decode", max_seq,
                                            batch), mesh, run)


def _flat_cache(cache, logical):
    """The cache tree's leaves and their logical axes as two flat dicts
    keyed by path (``layers/k``, ``tail/0/conv_x``, ...)."""
    flat = tfm.flat_cache(cache, logical)
    return ({k: c for k, (c, _) in flat.items()},
            {k: lg for k, (_, lg) in flat.items()})


def build_cell(arch: str, shape_name: str, mesh: Mapping,
               run: Optional[RunConfig] = None, *,
               smoke: bool = False) -> Cell:
    cfg = get_config(arch, smoke=smoke)
    shape = SHAPES[shape_name]
    ok, why = applicable(cfg, shape)
    if not ok:
        raise SkipCell(why)
    run = run or default_run(arch, shape)
    rules = make_cell_rules(cfg, shape, mesh, run)
    B, T = shape.global_batch, shape.seq_len
    meta = {
        "arch": arch, "shape": shape_name, "kind": shape.kind,
        "params": cfg.param_count(), "active_params": cfg.active_param_count(),
        "global_batch": B, "seq_len": T, "mesh": axis_sizes(mesh),
        "microbatch": run.microbatch, "act_shard_model": run.act_shard_model,
        "attention_impl": run.attention_impl,
    }
    defs = tfm.model_defs(cfg)
    pspecs = param_specs(defs, rules)
    row = rules.spec(("batch", "seq"))
    n_text = T - cfg.n_prefix_embeds
    state, specs = {}, {}
    if shape.kind == "train":
        state["params"] = abstract_params(defs,
                                          getattr(torch, run.param_dtype))
        for grp in ("grads", "m", "v"):
            state[grp] = abstract_params(defs, torch.float32)
    else:
        state["params"] = abstract_params(defs,
                                          getattr(torch, run.compute_dtype))
    for grp in state:
        specs[grp] = pspecs
    n_tok = 1 if shape.kind == "decode" else n_text
    state["batch"] = {  # a train batch holds the labels' extra token
        "tokens": torch.empty((B, n_tok + (shape.kind == "train")),
                              dtype=torch.int32, device="meta"),
        "positions": torch.empty((B, n_tok), dtype=torch.int32,
                                 device="meta")}
    specs["batch"] = {"tokens": row, "positions": row}
    if cfg.n_prefix_embeds and shape.kind != "decode":
        state["batch"]["prefix_embeds"] = torch.empty(
            (B, cfg.n_prefix_embeds, cfg.d_model), dtype=torch.bfloat16,
            device="meta")
        specs["batch"]["prefix_embeds"] = rules.spec(("batch", "seq", None))
    if shape.kind == "decode":
        bs = _batch_shards(mesh)
        cache = tfm.init_cache(cfg, B, T, getattr(torch, run.compute_dtype),
                               device="meta")
        logical = tfm.cache_logical(
            cfg, batch_shardable=B % bs == 0,
            seq_shard=B % bs != 0 and run.seq_shard_decode)
        leaves, axes = _flat_cache(cache, logical)
        state["cache"] = leaves
        specs["cache"] = {k: rules.spec(lg) for k, lg in axes.items()}
    return Cell(arch, shape, cfg, run, state, specs, meta)
