"""Decoder stack of the attention families: pre-norm blocks of GQA or MLA
attention and a SwiGLU MLP or an MoE, with optional prefix embeddings.

Counterpart of the dense / moe / vlm / audio half of
:mod:`repro.models.transformer` (``model_defs``, ``init_model``,
``init_cache``, ``make_forward``).  The parameter table keeps the JAX
package's flat keys and shapes (``"layers/attn/wq"`` of shape (L, d, H *
hd), ``"dense0/mlp/w_gate"`` for deepseek-v2's leading dense layer, ...);
the module holds the leading dense blocks in ``dense`` and the stacked
ones in ``layers`` (both ``nn.ModuleList``) and is built from such a table
by :func:`repro_torch.models.convert.from_jax_params`.  The cache is the
JAX package's tree: ``{"layers": <stacked cache>, "dense0": ...}``.
SSM/hybrid and RWKV wait for later slices: their configs raise
``NotImplementedError``.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..config.base import ModelConfig, RunConfig
from ..core.graph import resolve_device
from .attention import (GQA, MLA, SENTINEL, AttnCache, MLACache, attn_defs,
                        mla_defs)
from .layers import MLP, mlp_defs, rms_norm
from .moe import MoE, moe_defs
from .params import ParamDef, init_params, prefixed, stacked


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for what the port does not build yet."""
    missing = [name for name in ("ssm", "rwkv")
               if getattr(cfg, name) is not None]
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(missing)} not ported yet; the port "
            "builds the attention families (dense, MoE, MLA, prefix "
            "embeddings)")


def first_dense_layers(cfg: ModelConfig) -> int:
    """Leading dense blocks before the stacked ones (deepseek-v2: 1)."""
    return cfg.moe.first_dense_layers if cfg.moe is not None else 0


def _block_defs(cfg: ModelConfig, *, use_moe: bool) -> dict[str, ParamDef]:
    defs = {"ln1": ParamDef((cfg.d_model,), (None,), "ones"),
            "ln2": ParamDef((cfg.d_model,), (None,), "ones")}
    a_defs = mla_defs(cfg) if cfg.mla is not None else attn_defs(cfg)
    defs.update(prefixed(a_defs, "attn/"))
    if use_moe:
        defs.update(prefixed(moe_defs(cfg), "moe/"))
    else:
        defs.update(prefixed(mlp_defs(cfg.d_model, cfg.d_ff), "mlp/"))
    return defs


def model_defs(cfg: ModelConfig) -> dict[str, ParamDef]:
    check_supported(cfg)
    d = cfg.d_model
    defs = {
        "embed": ParamDef((cfg.vocab_size, d), ("vocab", "embed"), "normal",
                          0.02),
        "final_ln": ParamDef((d,), (None,), "ones"),
    }
    if not cfg.tie_embeddings:
        defs["unembed"] = ParamDef((d, cfg.vocab_size), ("embed", "vocab"))
    first = first_dense_layers(cfg)
    defs.update(stacked(_block_defs(cfg, use_moe=cfg.moe is not None),
                        cfg.n_layers - first, "layers/"))
    for i in range(first):
        defs.update(prefixed(_block_defs(cfg, use_moe=False), f"dense{i}/"))
    return defs


def init_model(cfg: ModelConfig, generator: torch.Generator,
               dtype=torch.float32) -> dict[str, torch.Tensor]:
    """Random flat params (JAX keys and shapes) on ``generator``'s device;
    :func:`repro_torch.models.convert.from_jax_params` makes the module."""
    return init_params(model_defs(cfg), generator, dtype)


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               dtype=torch.bfloat16, device=None) -> dict:
    """Empty decode cache, the JAX package's tree: ``{"layers": cache of
    the stacked blocks (leading dim L), "dense{i}": cache of leading dense
    block i}``.  GQA: :class:`AttnCache` k, v (..., B, S, Hkv*hd) zeros
    and pos (..., B, S) ``SENTINEL``, S = ``max_seq`` (or the sliding
    window, if smaller: a ring).  MLA: :class:`MLACache` ckv (..., B,
    max_seq, kv_lora), krope (..., B, max_seq, rope_dim), pos.
    ``device=None`` means ``"cuda"``."""
    check_supported(cfg)
    dev = resolve_device(device)
    if cfg.mla is not None:
        m = cfg.mla
        seq = max_seq
        widths = (m.kv_lora_rank, m.rope_head_dim)
        kind = MLACache
    else:
        kvf = cfg.n_kv_heads * cfg.resolved_head_dim
        seq = (min(max_seq, cfg.sliding_window) if cfg.sliding_window
               else max_seq)
        widths = (kvf, kvf)
        kind = AttnCache

    def one(lead):
        shape = (*lead, batch, seq)
        return kind(*(torch.zeros((*shape, w), dtype=dtype, device=dev)
                      for w in widths),
                    torch.full(shape, SENTINEL, dtype=torch.int32,
                               device=dev))

    first = first_dense_layers(cfg)
    cache = {"layers": one((cfg.n_layers - first,))}
    for i in range(first):
        cache[f"dense{i}"] = one(())
    return cache


class Block(nn.Module):
    """Pre-norm block: ``x + attn(norm(x))``, then ``x + ffn(norm(x))``;
    attention is :class:`GQA` or :class:`MLA`, the ffn an ``mlp``
    (:class:`MLP`) or a ``moe`` (:class:`MoE`)."""

    def __init__(self, cfg: ModelConfig, run: RunConfig, *, use_moe: bool):
        super().__init__()
        self.eps = cfg.norm_eps
        self.run = run
        self.ln1 = nn.Parameter(torch.ones(cfg.d_model))
        self.ln2 = nn.Parameter(torch.ones(cfg.d_model))
        self.attn = MLA(cfg, run) if cfg.mla is not None else GQA(cfg, run)
        if use_moe:
            self.moe = MoE(cfg)
        else:
            self.mlp = MLP(cfg.d_model, cfg.d_ff)

    def forward(self, x, positions, cache=None, cache_pos=0):
        """Returns ``(x, cache, aux)``; ``aux`` is the MoE's load-balancing
        loss (f32 scalar), 0 for an MLP block."""
        h, cache = self.attn(rms_norm(x, self.ln1, self.eps), positions,
                             cache, cache_pos)
        x = x + h
        h = rms_norm(x, self.ln2, self.eps)
        if hasattr(self, "moe"):
            h, aux = self.moe(h, groups=self.run.moe_groups,
                              dense_eval=self.run.moe_dense_eval)
        else:
            h, aux = self.mlp(h), torch.zeros((), device=x.device)
        return x + h, cache, aux


class Transformer(nn.Module):
    """The decoder: embed (after any prefix embeddings), the leading dense
    blocks, the stacked blocks, final norm, unembed."""

    def __init__(self, cfg: ModelConfig, run: RunConfig):
        super().__init__()
        check_supported(cfg)
        self.cfg, self.run = cfg, run
        self.embed = nn.Embedding(cfg.vocab_size, cfg.d_model)
        self.final_ln = nn.Parameter(torch.ones(cfg.d_model))
        if not cfg.tie_embeddings:
            self.unembed = nn.Linear(cfg.d_model, cfg.vocab_size, bias=False)
        first = first_dense_layers(cfg)
        self.dense = nn.ModuleList(Block(cfg, run, use_moe=False)
                                   for _ in range(first))
        self.layers = nn.ModuleList(
            Block(cfg, run, use_moe=cfg.moe is not None)
            for _ in range(cfg.n_layers - first))

    def blocks(self) -> list:
        """Every block in the order the forward runs them."""
        return [*self.dense, *self.layers]

    def forward(self, tokens: torch.Tensor, positions: torch.Tensor,
                cache: Optional[dict] = None, cache_pos: int = 0, *,
                prefix_embeds: Optional[torch.Tensor] = None):
        """tokens, positions: (B, T) int32.  ``prefix_embeds`` (B, P, d),
        when given, go before the tokens at positions 0..P-1 and the
        tokens' positions shift by P (the JAX package's vlm stub).
        Returns ``(logits (B, P + T, V) f32, cache, aux)``, as JAX's
        forward: the cache (from :func:`init_cache`) is updated in place at
        slots ``cache_pos`` onward (mod S for a ring), ``aux`` the MoE
        losses summed over the blocks (f32 scalar)."""
        dtype = getattr(torch, self.run.compute_dtype)
        x = F.embedding(tokens, self.embed.weight).to(dtype)
        if prefix_embeds is not None:
            B, P = prefix_embeds.shape[:2]
            x = torch.cat([prefix_embeds.to(dtype), x], dim=1)
            ppos = torch.arange(P, dtype=torch.int32,
                                device=tokens.device).expand(B, P)
            positions = torch.cat([ppos, positions + P], dim=1)
        aux = torch.zeros((), device=x.device)
        for i, block in enumerate(self.dense):
            c = None if cache is None else cache[f"dense{i}"]
            x, _, a = block(x, positions, c, cache_pos)
            aux = aux + a
        for i, block in enumerate(self.layers):
            c = None if cache is None else type(cache["layers"])(
                *(t[i] for t in cache["layers"]))
            x, _, a = block(x, positions, c, cache_pos)
            aux = aux + a
        x = rms_norm(x, self.final_ln, self.cfg.norm_eps)
        w = (self.embed.weight if self.cfg.tie_embeddings
             else self.unembed.weight)
        return F.linear(x.float(), w.float()), cache, aux
