"""Decoder stack of the dense family: pre-norm blocks of GQA attention and a
SwiGLU MLP.

Counterpart of the dense half of :mod:`repro.models.transformer`
(``model_defs``, ``init_model``, ``init_cache``, ``make_forward``).  The
parameter table keeps the JAX package's flat keys and shapes
(``"layers/attn/wq"`` of shape (L, d, H * hd), ...); the module holds one
:class:`Block` per layer in an ``nn.ModuleList`` and is built from such a
table by :func:`repro_torch.models.convert.from_jax_params`.  MoE, MLA,
SSM/hybrid, RWKV and modality prefixes wait for later slices: their
configs raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..config.base import ModelConfig, RunConfig
from ..core.graph import resolve_device
from .attention import SENTINEL, GQA, AttnCache, attn_defs
from .layers import MLP, mlp_defs, rms_norm
from .params import ParamDef, init_params, prefixed, stacked


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for what the port does not build yet."""
    missing = [name for name in ("moe", "mla", "ssm", "rwkv")
               if getattr(cfg, name) is not None]
    if cfg.n_prefix_embeds:
        missing.append("n_prefix_embeds")
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(missing)} not ported yet; the port "
            "builds the dense GQA family only")


def _block_defs(cfg: ModelConfig) -> dict[str, ParamDef]:
    defs = {"ln1": ParamDef((cfg.d_model,), (None,), "ones"),
            "ln2": ParamDef((cfg.d_model,), (None,), "ones")}
    defs.update(prefixed(attn_defs(cfg), "attn/"))
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
    defs.update(stacked(_block_defs(cfg), cfg.n_layers, "layers/"))
    return defs


def init_model(cfg: ModelConfig, generator: torch.Generator,
               dtype=torch.float32) -> dict[str, torch.Tensor]:
    """Random flat params (JAX keys and shapes) on ``generator``'s device;
    :func:`repro_torch.models.convert.from_jax_params` makes the module."""
    return init_params(model_defs(cfg), generator, dtype)


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               dtype=torch.bfloat16, device=None) -> AttnCache:
    """Empty decode cache: k, v (L, B, S, Hkv*hd) zeros and pos (L, B, S)
    ``SENTINEL``, with S = ``max_seq`` (or the sliding window, if
    smaller).  ``device=None`` means ``"cuda"``."""
    check_supported(cfg)
    dev = resolve_device(device)
    kvf = cfg.n_kv_heads * cfg.resolved_head_dim
    seq = min(max_seq, cfg.sliding_window) if cfg.sliding_window else max_seq
    shape = (cfg.n_layers, batch, seq)
    return AttnCache(
        k=torch.zeros((*shape, kvf), dtype=dtype, device=dev),
        v=torch.zeros((*shape, kvf), dtype=dtype, device=dev),
        pos=torch.full(shape, SENTINEL, dtype=torch.int32, device=dev))


class Block(nn.Module):
    """Pre-norm block: ``x + attn(norm(x))``, then ``x + mlp(norm(x))``."""

    def __init__(self, cfg: ModelConfig, run: RunConfig):
        super().__init__()
        self.eps = cfg.norm_eps
        self.ln1 = nn.Parameter(torch.ones(cfg.d_model))
        self.ln2 = nn.Parameter(torch.ones(cfg.d_model))
        self.attn = GQA(cfg, run)
        self.mlp = MLP(cfg.d_model, cfg.d_ff)

    def forward(self, x, positions, cache=None, cache_pos=0):
        h, cache = self.attn(rms_norm(x, self.ln1, self.eps), positions,
                             cache, cache_pos)
        x = x + h
        return x + self.mlp(rms_norm(x, self.ln2, self.eps)), cache


class Transformer(nn.Module):
    """The dense decoder: embed, ``n_layers`` blocks, final norm, unembed."""

    def __init__(self, cfg: ModelConfig, run: RunConfig):
        super().__init__()
        check_supported(cfg)
        self.cfg, self.run = cfg, run
        self.embed = nn.Embedding(cfg.vocab_size, cfg.d_model)
        self.final_ln = nn.Parameter(torch.ones(cfg.d_model))
        if not cfg.tie_embeddings:
            self.unembed = nn.Linear(cfg.d_model, cfg.vocab_size, bias=False)
        self.layers = nn.ModuleList(Block(cfg, run)
                                    for _ in range(cfg.n_layers))

    def forward(self, tokens: torch.Tensor, positions: torch.Tensor,
                cache: Optional[AttnCache] = None, cache_pos: int = 0):
        """tokens, positions: (B, T) int32.  Returns ``(logits (B, T, V)
        f32, cache)``; the cache (from :func:`init_cache`) is updated in
        place at slots ``cache_pos % S`` onward."""
        x = F.embedding(tokens, self.embed.weight).to(
            getattr(torch, self.run.compute_dtype))
        for i, block in enumerate(self.layers):
            layer_cache = None if cache is None else AttnCache(
                cache.k[i], cache.v[i], cache.pos[i])
            x, _ = block(x, positions, layer_cache, cache_pos)
        x = rms_norm(x, self.final_ln, self.cfg.norm_eps)
        w = (self.embed.weight if self.cfg.tie_embeddings
             else self.unembed.weight)
        return F.linear(x.float(), w.float()), cache
