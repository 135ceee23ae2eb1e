"""Attention: GQA (the dense reference, the flash kernel, the chunked
flash-style twins, single-token decode) and MLA (compressed KV with the
absorbed decode path).

Counterpart of :mod:`repro.models.attention`.  Projection weights are
``nn.Linear`` in PyTorch's (out, in) layout over the flattened head dim
(``H * hd``), as JAX's flat ``(d, H * hd)`` tables transposed
(:mod:`repro_torch.models.convert`).  The attention core is a submodule
(:class:`AttentionCore`) of both blocks, so a forward hook sees its q, k,
v, positions and output: every prefill of either block runs through it.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..config.base import ModelConfig, RunConfig
from ..kernels import ops as kops
from ..sharding.rules import gathered, model_shards, run_local, write_into
from .layers import apply_rope, linear, rms_norm, rope_tables
from .params import ParamDef

NEG_INF = -1e30
SENTINEL = 2**30  # position of an empty cache slot


class AttnCache(NamedTuple):
    """Decode cache with flattened kv feature dim: k, v (..., B, S, Hkv*hd).

    ``pos`` holds the absolute position in each slot (``SENTINEL`` =
    empty), so a sliding-window cache is a plain ring buffer: the write
    index is ``cache_pos % S`` and masking falls out of the position
    comparison.  Unlike the JAX package's functional update, the port
    writes new keys into these tensors in place (a decode step then moves
    O(new tokens), not the whole cache).
    """

    k: torch.Tensor
    v: torch.Tensor
    pos: torch.Tensor  # (..., B, S) int32


def attn_defs(cfg: ModelConfig) -> dict[str, ParamDef]:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    out_q, out_kv = cfg.n_heads * hd, cfg.n_kv_heads * hd
    defs = {
        "wq": ParamDef((d, out_q), ("embed", "heads_flat")),
        "wk": ParamDef((d, out_kv), ("embed", "kv_flat")),
        "wv": ParamDef((d, out_kv), ("embed", "kv_flat")),
        "wo": ParamDef((out_q, d), ("heads_flat", "embed")),
    }
    if cfg.qkv_bias:
        defs["bq"] = ParamDef((out_q,), ("heads_flat",), "zeros")
        defs["bk"] = ParamDef((out_kv,), ("kv_flat",), "zeros")
        defs["bv"] = ParamDef((out_kv,), ("kv_flat",), "zeros")
    if cfg.qk_norm:
        defs["q_norm"] = ParamDef((hd,), (None,), "ones")
        defs["k_norm"] = ParamDef((hd,), (None,), "ones")
    return defs


def _grouped(q, k):
    """q (B, T, H, hd) as (B, T, Hkv, G, hd), matching k's (B, S, Hkv, hd)."""
    B, T, H, hd = q.shape
    Hkv = k.shape[2]
    return q.reshape(B, T, Hkv, H // Hkv, hd)


def _bias(q_pos, kv_pos, window):
    """(B, T, S) f32: 0 where key s is visible to query t, else NEG_INF."""
    mask = kv_pos[:, None, :] <= q_pos[:, :, None]
    if window is not None:
        mask &= kv_pos[:, None, :] > q_pos[:, :, None] - window
    return torch.where(mask, 0.0, NEG_INF)


def _dense_attention(q, k, v, q_pos, kv_pos, window: Optional[int]):
    """Rectangular attention: f32 scores, weights cast to v's dtype."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("btkgd,bskd->bkgts", _grouped(q, k).float(),
                          k.float()) * scale
    scores = scores + _bias(q_pos, kv_pos, window)[:, None, None]
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgts,bskd->btkgd", w.to(v.dtype), v)
    return out.reshape(q.shape)


def _decode_attention(q, k, v, q_pos, kv_pos, window):
    """Single-token decode: q (B, 1, H, hd) against the whole cache."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("btkgd,bskd->bkgts", _grouped(q, k).float(),
                     k.float()) * scale
    s = s + _bias(q_pos, kv_pos, window)[:, None, None]
    w = torch.softmax(s, dim=-1).to(v.dtype)
    out = torch.einsum("bkgts,bskd->btkgd", w, v)
    return out.reshape(q.shape)


def _blocks(n: int, size: int) -> "list[tuple[int, int]]":
    """(start, end) of ``size``-long blocks over ``n``; the last may be
    shorter."""
    return [(a, min(a + size, n)) for a in range(0, n, size)]


def _block_bounds(pos: torch.Tensor, size: int):
    """(min, max) of ``pos`` (B, n) over each ``size``-long block: (B,
    n_blocks) each."""
    B, n = pos.shape
    nb = -(-n // size)
    # the ragged last block repeats its last element (neutral to min/max)
    idx = torch.arange(nb * size, device=pos.device).clamp_(max=n - 1)
    blocks = pos[:, idx].view(B, nb, size)
    return blocks.amin(-1), blocks.amax(-1)


def _visible_blocks(q_pos, kv_pos, window, q_size, kv_size):
    """(n_q, n_kv) host list: False where no query of q block i can see
    any key of kv block j (every key after the block's last query, or,
    with a window, at or before its first query's window start), for any
    batch row.  Decided by position, never by row index, so a write into a
    cache at any ``cache_pos`` (a ring too) skips only what is invisible.
    One device-to-host copy of a small bool table."""
    q_min, q_max = _block_bounds(q_pos, q_size)
    kv_min, kv_max = _block_bounds(kv_pos, kv_size)
    vis = kv_min[:, None, :] <= q_max[:, :, None]
    if window is not None:
        vis &= kv_max[:, None, :] > q_min[:, :, None] - window
    return vis.any(0).tolist()


def _flash_rows(qg, k, v, q_pos, kv_pos, window, blocks):
    """Online softmax over the kv ``blocks`` ((start, end) key ranges) for
    one query block, as JAX's ``_flash_rows``: q scaled in its own dtype,
    scores and the running max, sum and accumulator in f32, the weights
    cast to v's dtype before the weighted sum (f32 accumulation).

    qg (B, Tq, Hkv, G, hd); k, v (B, S, Hkv, hd).  Returns (B, Tq, Hkv, G,
    hd) f32.  A query that sees no key of the blocks gets 0."""
    B, Tq, Hkv, G, hd = qg.shape
    qf = (qg * (1.0 / math.sqrt(hd))).to(qg.dtype).float()
    m = qf.new_full((B, Hkv, G, Tq), NEG_INF)
    l = qf.new_zeros((B, Hkv, G, Tq))
    acc = qf.new_zeros((B, Hkv, G, Tq, hd))
    for a, b in blocks:
        s = torch.einsum("btkgd,bskd->bkgts", qf, k[:, a:b].float())
        s = s + _bias(q_pos, kv_pos[:, a:b], window)[:, None, None]
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        vc = v[:, a:b]
        acc = acc * corr[..., None] + torch.einsum(
            "bkgts,bskd->bkgtd", p.to(vc.dtype).float(), vc.float())
        m = m_new
    out = acc / l.clamp(min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4)


def _chunked_attention(q, k, v, q_pos, kv_pos, window, chunk, *,
                       triangular, remat_rows=False):
    """JAX's ``_chunked_attention`` in torch ops: the queries in blocks of
    ``min(chunk, T)``, each an online softmax (:func:`_flash_rows`) over
    kv blocks of ``min(chunk, S)`` keys; a ragged last block of either is
    shorter (JAX shrinks the chunk to ``gcd(T, chunk)`` instead).

    ``triangular=True`` (``"chunked_causal"``) skips the kv blocks that no
    query of the row sees, decided by position (:func:`_visible_blocks`):
    the reference slices kv by the query row's index, which is right only
    for a write at ``cache_pos`` 0.  ``remat_rows`` recomputes each row's
    kv loop in the backward (``torch.utils.checkpoint``), so the backward
    holds one row's scores at a time: O(T * chunk), not O(T^2).  Returns
    (B, T, H, hd) in v's dtype."""
    B, T, H, hd = q.shape
    S = k.shape[1]
    q_blocks = _blocks(T, min(chunk, T))
    kv_blocks = _blocks(S, min(chunk, S))
    vis = (_visible_blocks(q_pos, kv_pos, window, min(chunk, T),
                           min(chunk, S)) if triangular else None)
    qg = _grouped(q, k)
    outs = []
    for i, (a, b) in enumerate(q_blocks):
        blocks = (kv_blocks if vis is None
                  else [blk for blk, seen in zip(kv_blocks, vis[i]) if seen])
        args = (qg[:, a:b], k, v, q_pos[:, a:b], kv_pos, window, blocks)
        outs.append(checkpoint(_flash_rows, *args, use_reentrant=False,
                               preserve_rng_state=False)
                    if remat_rows else _flash_rows(*args))
    return torch.cat(outs, 1).reshape(B, T, H, hd).to(v.dtype)


def attention_core(q, k, v, q_pos, kv_pos, *, impl: str,
                   window: Optional[int], chunk: int = 1024,
                   remat_rows: bool = False):
    """q (B, T, H, hd), k/v (B, S, Hkv, hd) -> (B, T, H, hd).

    One query against a longer cache takes the decode path whatever
    ``impl`` says (as in JAX); ``"flash"`` is the CUDA kernel (its plain
    version on a CPU tensor; under autograd its backward recomputes
    through the ``"chunked_causal"`` twin at ``chunk``), ``"dense"`` the
    einsum reference, ``"chunked"`` and ``"chunked_causal"`` the twins
    (:func:`_chunked_attention`, rectangular and triangular).
    """
    if q.shape[1] == 1 and k.shape[1] > 1:
        return _decode_attention(q, k, v, q_pos, kv_pos, window)
    if impl == "dense":
        return _dense_attention(q, k, v, q_pos, kv_pos, window)
    if impl == "flash":
        return kops.flash_attention(q, k, v, q_pos, kv_pos, window=window,
                                    chunk=chunk)
    if impl in ("chunked", "chunked_causal"):
        return _chunked_attention(q, k, v, q_pos, kv_pos, window, chunk,
                                  triangular=impl == "chunked_causal",
                                  remat_rows=remat_rows)
    raise ValueError(f"unknown attention impl {impl!r}")


def head_shards(mesh, n_heads: int, n_kv_heads: int) -> int:
    """The model axis's size, checked to split both head counts evenly:
    a rank then holds whole heads, and its q heads are exactly the GQA
    groups of its kv heads (model = 2, H 32, Hkv 8: rank 0 holds q heads
    0-15 and kv heads 0-3).  JAX pads an uneven split (GSPMD); a
    ``local_map`` cannot, so this raises."""
    model_shards(mesh, n_heads, "q heads")
    return model_shards(mesh, n_kv_heads, "kv heads")


class AttentionCore(nn.Module):
    """:func:`attention_core` as a module (no weights): the seam a forward
    hook uses to see each layer's q, k, v, positions and output.

    Under a mesh (``shard=(mesh, rules)``, DTensor inputs) the core runs
    through ``local_map``: q, k and v sharded on the heads dim over the
    model axis (and on the batch over the batch axes), the positions
    replicated over the model axis, so the flash kernel, its autograd
    Function and :func:`~repro_torch.kernels.flash_attention.keep_outputs`
    see plain tensors of the rank's own heads.  The output is a DTensor
    placed as q."""

    def __init__(self, run: RunConfig, window: Optional[int]):
        super().__init__()
        self.impl = run.attention_impl
        self.chunk = run.attention_chunk
        self.remat_rows = run.remat_attention
        self.window = window

    def _core(self, q, k, v, q_pos, kv_pos):
        return attention_core(q, k, v, q_pos, kv_pos, impl=self.impl,
                              window=self.window, chunk=self.chunk,
                              remat_rows=self.remat_rows)

    def _local(self, q, k, v, q_pos, kv_pos):
        """The core on one rank's local tensors (inside ``local_map``)."""
        return self._core(*(t.contiguous() for t in (q, k, v, q_pos,
                                                      kv_pos)))

    def forward(self, q, k, v, q_pos, kv_pos, shard=None):
        if shard is None:
            return self._core(q, k, v, q_pos, kv_pos)
        head_shards(shard[0], q.shape[2], k.shape[2])
        heads = ("batch", "seq", "heads_flat", None)
        pos = ("batch", "seq")
        return run_local(self._local, shard, (heads, heads, heads, pos, pos),
                         heads, q, k, v, q_pos, kv_pos)


def _ring_loss(T: int, cache_pos: int, S: int, window: Optional[int]) -> bool:
    """Whether a write of T keys at ``cache_pos`` (positions ``cache_pos``
    onward, slot = position mod S) overwrites a key that an earlier query
    of the same write still sees.  New key j replaces the key at position
    ``cache_pos + j - S`` (a real key once that is >= 0), which query i <
    j sees unless the window has passed it: ``j - S > i - window``, so at
    i = 0 when ``j > S - window``."""
    first = max(1, S - cache_pos)  # the first j that replaces a real key
    if window is not None:
        first = max(first, S - window + 1)
    return T - 1 >= first


class GQA(nn.Module):
    """The GQA block body (no residual or norm), as JAX's ``gqa_apply``."""

    def __init__(self, cfg: ModelConfig, run: RunConfig):
        super().__init__()
        d, hd = cfg.d_model, cfg.resolved_head_dim
        self.cfg = cfg
        self.wq = nn.Linear(d, cfg.n_heads * hd, bias=cfg.qkv_bias)
        self.wk = nn.Linear(d, cfg.n_kv_heads * hd, bias=cfg.qkv_bias)
        self.wv = nn.Linear(d, cfg.n_kv_heads * hd, bias=cfg.qkv_bias)
        self.wo = nn.Linear(cfg.n_heads * hd, d, bias=False)
        if cfg.qk_norm:
            self.q_norm = nn.Parameter(torch.ones(hd))
            self.k_norm = nn.Parameter(torch.ones(hd))
        self.core = AttentionCore(run, cfg.sliding_window)

    @staticmethod
    def _proj(lin: nn.Linear, x: torch.Tensor) -> torch.Tensor:
        b = None if lin.bias is None else lin.bias.to(x.dtype)
        return F.linear(x, gathered(lin.weight).to(x.dtype), b)

    def forward(self, x: torch.Tensor, positions: torch.Tensor,
                cache: Optional[AttnCache] = None, cache_pos: int = 0,
                shard=None):
        """x (B, T, d), positions (B, T) int32.  With a cache (one layer's
        k, v (B, S, Hkv*hd) and pos (B, S)), the new keys are written at
        slots ``cache_pos % S`` onward and the whole cache is attended.  A
        write of T > 1 keys that would overwrite a ring slot whose key an
        earlier query of the same write still sees raises (the keys are
        attended after the write).  ``shard=(mesh, rules)``: x, positions
        and the weights are DTensors, the core runs on each rank's heads
        (:class:`AttentionCore`), and a cache placed by its logical axes
        (``kv_seq``: the sequence split over the batch axes) takes each
        rank's part of the write (:func:`~repro_torch.sharding.rules.
        write_into`) and is read whole on the sequence by the core.
        Returns ``(out (B, T, d), cache)``."""
        cfg = self.cfg
        B, T, _ = x.shape
        hd, H, Hkv = cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads
        q = self._proj(self.wq, x).reshape(B, T, H, hd)
        k = self._proj(self.wk, x).reshape(B, T, Hkv, hd)
        v = self._proj(self.wv, x).reshape(B, T, Hkv, hd)
        if cfg.qk_norm:
            q = rms_norm(q, self.q_norm, cfg.norm_eps)
            k = rms_norm(k, self.k_norm, cfg.norm_eps)
        cos, sin = rope_tables(positions, hd, cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)

        kv_pos = positions
        if cache is not None:
            S = cache.k.shape[1]
            write = cache_pos % S
            if write + T > S:
                raise ValueError(f"{T} new keys at slot {write} overflow a "
                                 f"cache of {S} slots")
            if _ring_loss(T, cache_pos, S, cfg.sliding_window):
                raise ValueError(f"{T} new keys at position {cache_pos} "
                                 f"overwrite keys of a {S}-slot ring that "
                                 "earlier queries of the write still see")
            write_into(cache.k, k.reshape(B, T, Hkv * hd), 1, write)
            write_into(cache.v, v.reshape(B, T, Hkv * hd), 1, write)
            write_into(cache.pos, positions, 1, write)
            k = cache.k.view(B, S, Hkv, hd).to(x.dtype)
            v = cache.v.view(B, S, Hkv, hd).to(x.dtype)
            kv_pos = cache.pos
        out = self.core(q, k, v, positions, kv_pos,
                        shard=shard).reshape(B, T, H * hd)
        return F.linear(out, gathered(self.wo.weight).to(x.dtype)), cache


# ----------------------------------------------------------------------------
# MLA (deepseek-v2): compressed-KV attention with the absorbed decode path
# ----------------------------------------------------------------------------

class MLACache(NamedTuple):
    """MLA's decode cache: the compressed kv ``ckv`` (..., B, S, kv_lora),
    the rotated shared key ``krope`` (..., B, S, rope_dim) and ``pos``
    (..., B, S) int32 (``SENTINEL`` = empty).  Written in place at
    ``cache_pos`` onward (no ring: MLA has no window)."""

    ckv: torch.Tensor
    krope: torch.Tensor
    pos: torch.Tensor


def mla_defs(cfg: ModelConfig) -> dict[str, ParamDef]:
    m = cfg.mla
    d, H = cfg.d_model, cfg.n_heads
    qk = m.nope_head_dim + m.rope_head_dim
    return {
        "wq_a": ParamDef((d, m.q_lora_rank), ("embed", "lora")),
        "q_norm": ParamDef((m.q_lora_rank,), (None,), "ones"),
        "wq_b": ParamDef((m.q_lora_rank, H * qk), ("lora", "heads_flat")),
        "wkv_a": ParamDef((d, m.kv_lora_rank + m.rope_head_dim),
                          ("embed", "lora")),
        "kv_norm": ParamDef((m.kv_lora_rank,), (None,), "ones"),
        "wk_b": ParamDef((m.kv_lora_rank, H * m.nope_head_dim),
                         ("lora", "heads_flat")),
        "wv_b": ParamDef((m.kv_lora_rank, H * m.v_head_dim),
                         ("lora", "heads_flat")),
        "wo": ParamDef((H * m.v_head_dim, d), ("heads_flat", "embed")),
    }


class MLA(nn.Module):
    """The MLA block body (no residual or norm), as JAX's ``mla_apply``.

    Queries and the compressed kv come through low-rank projections with
    RMS norms; RoPE turns only the ``rope_head_dim`` half.  A prefill
    decompresses per-head K (nope part from ``ckv``, the shared rope key
    broadcast to every head) and V, pads V with zeros to the qk head dim
    (``nope + rope``: 192 at full width) and runs the attention core on
    it, slicing V's width back after.  One query against a longer cache
    takes the absorbed path: ``wk_b`` folded into the query and ``wv_b``
    applied after the weighted sum, scores in f32, per-head K and V never
    built."""

    def __init__(self, cfg: ModelConfig, run: RunConfig):
        super().__init__()
        m, d, H = cfg.mla, cfg.d_model, cfg.n_heads
        self.cfg = cfg
        qk = m.nope_head_dim + m.rope_head_dim
        self.wq_a = nn.Linear(d, m.q_lora_rank, bias=False)
        self.q_norm = nn.Parameter(torch.ones(m.q_lora_rank))
        self.wq_b = nn.Linear(m.q_lora_rank, H * qk, bias=False)
        self.wkv_a = nn.Linear(d, m.kv_lora_rank + m.rope_head_dim,
                               bias=False)
        self.kv_norm = nn.Parameter(torch.ones(m.kv_lora_rank))
        self.wk_b = nn.Linear(m.kv_lora_rank, H * m.nope_head_dim,
                              bias=False)
        self.wv_b = nn.Linear(m.kv_lora_rank, H * m.v_head_dim, bias=False)
        self.wo = nn.Linear(H * m.v_head_dim, d, bias=False)
        self.core = AttentionCore(run, None)

    def forward(self, x: torch.Tensor, positions: torch.Tensor,
                cache: Optional[MLACache] = None, cache_pos: int = 0,
                shard=None):
        """x (B, T, d), positions (B, T) int32; with a cache (one layer's
        :class:`MLACache`) the new entries go to slots ``cache_pos``
        onward.  Returns ``(out (B, T, d), cache)``.

        Under ``shard=(mesh, rules)`` (DTensors) the low-rank projections
        are DTensor ops: q arrives split on heads over the model axis
        (``wq_b`` on ``"heads_flat"``), the compressed kv and the rope key
        whole on every rank (``"lora"`` is replicated).  The prefill
        decompresses K and V on each rank's own heads (:func:`_expand`,
        through ``local_map``; ``wk_b`` and ``wv_b`` are on
        ``"heads_flat"``), broadcasts the rope key to them, pads V to the
        qk head dim and runs the shared core on those heads.  The cache's
        sequence is on the model axis (``"mla_seq"``): each rank writes
        its part of the new slots, and the absorbed decode gathers the
        sequence whole on every rank (:func:`_absorbed`, through
        ``local_map``: one all-gather of the compressed cache, the rope
        key and the positions per layer and token)."""
        cfg, m = self.cfg, self.cfg.mla
        B, T, _ = x.shape
        H, dtype = cfg.n_heads, x.dtype
        nope, rope, L = m.nope_head_dim, m.rope_head_dim, m.kv_lora_rank
        if shard is not None:
            model_shards(shard[0], H, f"{cfg.name}: the MLA heads")
        q = rms_norm(linear(self.wq_a, x), self.q_norm, cfg.norm_eps)
        q = linear(self.wq_b, q).reshape(B, T, H, nope + rope)
        q_nope, q_rope = q.split([nope, rope], dim=-1)
        cos, sin = rope_tables(positions, rope, cfg.rope_theta)
        q_rope = apply_rope(q_rope, cos, sin)
        ckv, krope = linear(self.wkv_a, x).split([L, rope], dim=-1)
        ckv = rms_norm(ckv, self.kv_norm, cfg.norm_eps)
        krope = apply_rope(krope[:, :, None, :], cos, sin)[:, :, 0, :]

        kv_pos = positions
        if cache is not None:
            S = cache.ckv.shape[1]
            if cache_pos + T > S:
                raise ValueError(f"{T} new entries at slot {cache_pos} "
                                 f"overflow a cache of {S} slots")
            write_into(cache.ckv, ckv, 1, cache_pos)
            write_into(cache.krope, krope, 1, cache_pos)
            write_into(cache.pos, positions, 1, cache_pos)
            ckv, krope = cache.ckv.to(dtype), cache.krope.to(dtype)
            kv_pos = cache.pos
        S = ckv.shape[1]
        wk_b = self.wk_b.weight.T.to(dtype).reshape(L, H, nope)
        wv_b = self.wv_b.weight.T.to(dtype).reshape(L, H, m.v_head_dim)
        heads = ("batch", "seq", "heads_flat", None)
        whole = ("batch", "seq", None)
        w_heads = (None, "heads_flat", None)
        if T == 1 and S > 1:
            out = run_local(_absorbed, shard,
                            (heads, heads, whole, whole, ("batch", "seq"),
                             ("batch", "seq"), w_heads, w_heads),
                            heads, q_nope, q_rope, ckv, krope, positions,
                            kv_pos, wk_b, wv_b)
        else:
            k, v = run_local(_expand, shard,
                             (whole, whole, w_heads, w_heads),
                             [heads, heads], ckv, krope, wk_b, wv_b)
            qq = torch.cat([q_nope, q_rope], dim=-1)
            out = self.core(qq, k, v, positions, kv_pos,
                            shard=shard)[..., :m.v_head_dim]
        out = out.reshape(B, T, H * m.v_head_dim)
        return linear(self.wo, out), cache


def _expand(ckv, krope, wk_b, wv_b):
    """MLA's per-head K and V from the compressed cache, on plain tensors
    (one rank's heads under a mesh): K = [ckv wk_b, the rope key
    broadcast to every head], V = ckv wv_b zero-padded to K's head dim
    (the shared core takes one head dim; the caller slices V's width back
    after it).  ckv (B, S, L), krope (B, S, rope), wk_b (L, H, nope), wv_b
    (L, H, v)."""
    B, S, _ = ckv.shape
    H, rope = wk_b.shape[1], krope.shape[-1]
    k_nope = torch.einsum("bsl,lhn->bshn", ckv, wk_b)
    v = torch.einsum("bsl,lhv->bshv", ckv, wv_b)
    k = torch.cat([k_nope, krope[:, :, None, :].expand(B, S, H, rope)],
                  dim=-1)
    return k, F.pad(v, (0, k.shape[-1] - v.shape[-1]))


def _absorbed(q_nope, q_rope, ckv, krope, q_pos, kv_pos, wk_b, wv_b):
    """MLA's absorbed single-query decode on plain tensors (one rank's
    heads, the whole cache, under a mesh): ``wk_b`` folded into the query
    and ``wv_b`` applied after the weighted sum, scores in f32, per-head
    K and V never built.  Returns (B, 1, H, v) in the query's dtype."""
    dtype = q_nope.dtype
    scale = 1.0 / math.sqrt(q_nope.shape[-1] + q_rope.shape[-1])
    q_abs = torch.einsum("bthn,lhn->bthl", q_nope, wk_b)
    s = torch.einsum("bthl,bsl->bhts", q_abs.float(), ckv.float())
    s = s + torch.einsum("bthr,bsr->bhts", q_rope.float(), krope.float())
    s = s * scale + _bias(q_pos, kv_pos, None)[:, None]
    w = torch.softmax(s, dim=-1)
    ctx = torch.einsum("bhts,bsl->bthl", w.to(dtype).float(), ckv.float())
    return torch.einsum("bthl,lhv->bthv", ctx.to(dtype).float(),
                        wv_b.float()).to(dtype)
