"""Decoder stack of every family: the attention families (pre-norm blocks
of GQA or MLA attention and a SwiGLU MLP or an MoE, with optional prefix
embeddings), RWKV (time-mix + channel-mix blocks) and the zamba2 hybrid (a
Mamba2 backbone with one weight-shared attention block run after every
``attn_every`` Mamba2 blocks, then the tail blocks).

Counterpart of :mod:`repro.models.transformer` (``model_defs``,
``init_model``, ``zamba_plan``, ``init_cache``, ``cache_logical``,
``make_forward``).  The parameter table keeps the JAX package's flat keys
and shapes
(``"layers/attn/wq"`` of shape (L, d, H * hd), ``"dense0/mlp/w_gate"`` for
deepseek-v2's leading dense layer, ``"tail0/ssm/wx"`` and ``"shared/attn/wq"``
for the hybrid, ...); the module holds the leading dense blocks in
``dense``, the stacked ones in ``layers``, the hybrid's tail blocks in
``tail`` (all ``nn.ModuleList``) and its shared block in ``shared``, and is
built from such a table by :func:`repro_torch.models.convert.from_jax_params`.
The cache is the JAX package's tree (:func:`init_cache`), updated in place.

Remat follows JAX's ``make_forward``: under autograd without a cache, each
stacked block (RWKV's and the attention families' ``layers``; the hybrid's
super-block of ``attn_every`` Mamba2 blocks and the shared block) runs
under ``torch.utils.checkpoint`` (:func:`remat`); the leading dense blocks
and the hybrid's tail do not.  A recomputed block takes the flash
kernel's recorded output instead of launching it again.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (checkpoint,
                                    create_selective_checkpoint_contexts)

from ..config.base import ModelConfig, RunConfig
from ..core.graph import resolve_device
from ..kernels.flash_attention import keep_outputs
from ..sharding.rules import (constrain, distribute, full_placed, gathered,
                              is_dtensor, placements)
from .attention import (GQA, MLA, SENTINEL, AttnCache, MLACache, attn_defs,
                        mla_defs)
from .layers import MLP, mlp_defs, rms_norm
from .moe import MoE, moe_defs
from .params import ParamDef, init_params, prefixed, stacked
from .rwkv import ChannelMix, TimeMix, rwkv_defs
from .ssm import Mamba2, ssm_defs


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


def _rwkv_block_defs(cfg: ModelConfig) -> dict[str, ParamDef]:
    defs = {"ln1": ParamDef((cfg.d_model,), (None,), "ones"),
            "ln2": ParamDef((cfg.d_model,), (None,), "ones")}
    defs.update(prefixed(rwkv_defs(cfg), "mix/"))
    return defs


def _mamba_block_defs(cfg: ModelConfig) -> dict[str, ParamDef]:
    defs = {"ln": ParamDef((cfg.d_model,), (None,), "ones")}
    defs.update(prefixed(ssm_defs(cfg), "ssm/"))
    return defs


def zamba_plan(cfg: ModelConfig) -> "tuple[int, int, int]":
    """(n_super, per_super, n_tail) for the hybrid stack."""
    per = cfg.ssm.attn_every
    n_super = cfg.n_layers // per
    return n_super, per, cfg.n_layers - n_super * per


def model_defs(cfg: ModelConfig) -> dict[str, ParamDef]:
    d = cfg.d_model
    defs = {
        "embed": ParamDef((cfg.vocab_size, d), ("vocab", "embed"), "normal",
                          0.02),
        "final_ln": ParamDef((d,), (None,), "ones"),
    }
    if not cfg.tie_embeddings:
        defs["unembed"] = ParamDef((d, cfg.vocab_size), ("embed", "vocab"))
    if cfg.rwkv is not None:
        defs.update(stacked(_rwkv_block_defs(cfg), cfg.n_layers, "layers/"))
        return defs
    if cfg.ssm is not None:
        n_super, per, n_tail = zamba_plan(cfg)
        defs.update(stacked(_mamba_block_defs(cfg), n_super * per,
                            "layers/"))
        for t in range(n_tail):
            defs.update(prefixed(_mamba_block_defs(cfg), f"tail{t}/"))
        defs.update(prefixed(_block_defs(cfg, use_moe=False), "shared/"))
        return defs
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
               dtype=torch.bfloat16, device=None, *, mesh=None,
               rules=None) -> dict:
    """Empty decode cache, the JAX package's tree.  ``device=None`` means
    ``"cuda"``.  Under ``mesh`` and ``rules`` (those the model is placed
    by) every leaf is a DTensor placed by :func:`cache_logical`, each
    rank making only its own block: the batch on the batch axes when the
    rules shard it, the attention caches' sequence on them when the rules
    set ``kv_seq`` (JAX's ``seq_shard_decode`` for a batch that does not
    divide the batch shards: :func:`~repro_torch.launch.specs.
    serve_rules`), MLA's compressed cache's sequence on the model axis.

    * attention families: ``{"layers": cache of the stacked blocks
      (leading dim L), "dense{i}": cache of leading dense block i}``.
      GQA: :class:`AttnCache` k, v (..., B, S, Hkv*hd) zeros and pos (...,
      B, S) ``SENTINEL``, S = ``max_seq`` (or the sliding window, if
      smaller: a ring).  MLA: :class:`MLACache` ckv (..., B, max_seq,
      kv_lora), krope (..., B, max_seq, rope_dim), pos.
    * RWKV: ``{"state": (L, B, H, D, D) f32, "x_tm", "x_cm": (L, B, d)}``.
    * hybrid: ``{"mamba": {"conv_x" (n_super, per, B, W-1, di), "conv_B",
      "conv_C" (..., W-1, N), "state" (n_super, per, B, H, P, N) f32},
      "attn": AttnCache with leading dim n_super (the shared block's
      cache at each of its sites), "tail": [{...} per tail block]}``.
    """
    dev = resolve_device(device)
    if mesh is not None:
        cache = init_cache(cfg, batch, max_seq, dtype, "meta")
        logical = cache_logical(cfg, rules.table["batch"] is not None,
                                rules.table["kv_seq"] is not None)
        return map_cache(
            lambda t, lg: full_placed(
                t.shape, SENTINEL if t.dtype == torch.int32 else 0, mesh,
                placements(mesh, rules, lg), dtype=t.dtype, device=dev),
            cache, logical)
    d = cfg.d_model

    def zeros(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=dev)

    if cfg.rwkv is not None:
        H, D, L = d // cfg.rwkv.head_dim, cfg.rwkv.head_dim, cfg.n_layers
        return {"state": zeros(L, batch, H, D, D, dt=torch.float32),
                "x_tm": zeros(L, batch, d), "x_cm": zeros(L, batch, d)}
    if cfg.ssm is not None:
        s = cfg.ssm
        n_super, per, n_tail = zamba_plan(cfg)
        di, gn = s.expand * d, s.n_groups * s.d_state

        def mamba_cache(*lead):
            return {"conv_x": zeros(*lead, batch, s.conv_width - 1, di),
                    "conv_B": zeros(*lead, batch, s.conv_width - 1, gn),
                    "conv_C": zeros(*lead, batch, s.conv_width - 1, gn),
                    "state": zeros(*lead, batch, di // s.head_dim,
                                   s.head_dim, gn, dt=torch.float32)}

        kvf = cfg.n_kv_heads * cfg.resolved_head_dim
        return {"mamba": mamba_cache(n_super, per),
                "attn": AttnCache(
                    zeros(n_super, batch, max_seq, kvf),
                    zeros(n_super, batch, max_seq, kvf),
                    torch.full((n_super, batch, max_seq), SENTINEL,
                               dtype=torch.int32, device=dev)),
                "tail": [mamba_cache() for _ in range(n_tail)]}
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
        return kind(*(zeros(*shape, w) for w in widths),
                    torch.full(shape, SENTINEL, dtype=torch.int32,
                               device=dev))

    first = first_dense_layers(cfg)
    cache = {"layers": one((cfg.n_layers - first,))}
    for i in range(first):
        cache[f"dense{i}"] = one(())
    return cache


def map_cache(fn, cache, *trees, path=None):
    """:func:`init_cache`'s tree with ``fn(leaf, *the same leaf of each
    of trees)`` at every leaf (dicts, lists and cache tuples kept).  Given
    ``path`` (a prefix, ``""`` at the root), ``fn`` takes the leaf's path
    first: dict keys, list indices and cache-tuple fields joined by "/"
    (``layers/k``, ``tail/0/conv_x``)."""
    def sub(key, v, i):
        return map_cache(fn, v, *(t[i] for t in trees),
                         path=None if path is None else f"{path}{key}/")

    if isinstance(cache, dict):
        return {k: sub(k, v, k) for k, v in cache.items()}
    if isinstance(cache, list):
        return [sub(i, v, i) for i, v in enumerate(cache)]
    if isinstance(cache, tuple):
        return type(cache)(*(sub(f, v, i) for i, (f, v) in
                             enumerate(zip(cache._fields, cache))))
    return fn(cache, *trees) if path is None else fn(path[:-1], cache,
                                                     *trees)


def flat_cache(cache, *trees) -> dict:
    """``{path: leaf}`` of a cache tree (:func:`map_cache`'s paths), or
    ``{path: (leaf, *the same leaf of each of trees)}`` given trees."""
    out = {}

    def put(path, leaf, *others):
        out[path] = (leaf, *others) if trees else leaf

    map_cache(put, cache, *trees, path="")
    return out


def cache_logical(cfg: ModelConfig, batch_shardable: bool,
                  seq_shard: bool) -> dict:
    """Logical axes of every leaf of :func:`init_cache`'s tree (the same
    structure), JAX's exactly: the batch on ``"batch"`` when
    ``batch_shardable``, the attention caches' sequence on ``"kv_seq"``
    when ``seq_shard``, MLA's compressed cache on ``"mla_seq"``."""
    b = "batch" if batch_shardable else None
    s = "kv_seq" if seq_shard else None
    if cfg.rwkv is not None:
        return {"state": ("layers", b, None, None, None),
                "x_tm": ("layers", b, None), "x_cm": ("layers", b, None)}
    if cfg.ssm is not None:
        n_tail = zamba_plan(cfg)[2]

        def mamba_log(extra):
            return {"conv_x": (*extra, b, None, "ff"),
                    "conv_B": (*extra, b, None, None),
                    "conv_C": (*extra, b, None, None),
                    "state": (*extra, b, None, None, None)}

        return {"mamba": mamba_log(("layers", None)),
                "attn": AttnCache(("layers", b, s, "kv_flat"),
                                  ("layers", b, s, "kv_flat"),
                                  ("layers", b, s)),
                "tail": [mamba_log(()) for _ in range(n_tail)]}
    first = first_dense_layers(cfg)
    if cfg.mla is not None:
        sm = "mla_seq"  # the compressed cache shards over seq
        out = {"layers": MLACache(("layers", b, sm, None),
                                  ("layers", b, sm, None),
                                  ("layers", b, sm))}
        for i in range(first):
            out[f"dense{i}"] = MLACache((b, sm, None), (b, sm, None), (b, sm))
        return out
    out = {"layers": AttnCache(("layers", b, s, "kv_flat"),
                               ("layers", b, s, "kv_flat"),
                               ("layers", b, s))}
    for i in range(first):
        out[f"dense{i}"] = AttnCache((b, s, "kv_flat"), (b, s, "kv_flat"),
                                     (b, s))
    return out


def _dots_contexts():
    """Selective checkpointing for ``"dots"``: the matmul outputs (``mm``,
    ``addmm``, ``bmm``) are kept, the counterpart of JAX's
    ``checkpoint_dots_with_no_batch_dims`` (which keeps the unbatched dots
    only), and so is the flash kernel's output (its operator), so a
    recomputed block does not launch it again; the rest is recomputed."""
    aten = torch.ops.aten
    return create_selective_checkpoint_contexts(
        [aten.mm.default, aten.addmm.default, aten.bmm.default,
         torch.ops.repro_torch.flash_attention.default])


def remat(fn, mode: str):
    """``fn`` under ``torch.utils.checkpoint`` (non-reentrant) for
    ``mode`` ``"full"`` (everything recomputed in the backward but the
    flash kernel's outputs: :func:`~repro_torch.kernels.flash_attention.
    keep_outputs`) or ``"dots"`` (:func:`_dots_contexts`); ``fn`` itself
    for ``"none"`` or without grad mode.  ``"full"`` adds no cost per op;
    selective checkpointing dispatches every op of the block through
    Python (zamba2-1.2b's train step at B 1 x 4,096 on an H100: 9.5 s
    under it, 5.0 s without; ``PERF.md``)."""
    if mode == "none" or not torch.is_grad_enabled():
        return fn
    contexts = keep_outputs if mode == "full" else _dots_contexts

    def run(*args):  # the blocks draw no random numbers: no RNG state
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False, context_fn=contexts)

    return run


def _at(tree, *idx):
    """A view of one block's cache in a stacked cache tree (a dict or
    cache tuple of tensors with leading dims ``idx``)."""
    if isinstance(tree, dict):
        return {k: _pick(v, idx) for k, v in tree.items()}
    return type(tree)(*(_pick(t, idx) for t in tree))


def _pick(t, idx):
    """``t[idx]`` (leading dims, never sharded: ``"layers"`` replicates).
    A DTensor's is rebuilt from its local block's view: DTensor's own view
    ops refuse, under inference mode, a tensor made outside it."""
    if not is_dtensor(t):
        return t[idx]
    from torch.distributed.tensor import DTensor, Shard

    n = len(idx)
    return DTensor.from_local(
        t.to_local()[idx], t.device_mesh,
        [Shard(p.dim - n) if isinstance(p, Shard) else p
         for p in t.placements],
        run_check=False, shape=t.shape[n:], stride=t.stride()[n:])


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

    def forward(self, x, positions, cache=None, cache_pos=0, shard=None):
        """Returns ``(x, cache, aux)``; ``aux`` is the MoE's load-balancing
        loss (f32 scalar), 0 for an MLP block.  ``shard=(mesh, rules)``
        runs the block on DTensors (:class:`~repro_torch.models.attention.
        GQA`, :class:`~repro_torch.models.attention.MLA`,
        :class:`~repro_torch.models.moe.MoE`)."""
        h, cache = self.attn(rms_norm(x, self.ln1, self.eps), positions,
                             cache, cache_pos, shard)
        x = x + h
        h = rms_norm(x, self.ln2, self.eps)
        if hasattr(self, "moe"):
            h, aux = self.moe(h, groups=self.run.moe_groups,
                              dense_eval=self.run.moe_dense_eval,
                              shard=shard)
        else:
            h, aux = self.mlp(h), torch.zeros((), device=x.device)
        return x + h, cache, aux


class RWKVBlock(nn.Module):
    """``x + time_mix(norm(x))``, then ``x + channel_mix(norm(x))``, as
    JAX's ``_rwkv_block``: the mixes see the normed input, so the cache's
    ``x_tm`` / ``x_cm`` hold the last normed rows."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.eps = cfg.norm_eps
        self.ln1 = nn.Parameter(torch.ones(cfg.d_model))
        self.ln2 = nn.Parameter(torch.ones(cfg.d_model))
        self.time_mix = TimeMix(cfg)
        self.channel_mix = ChannelMix(cfg)

    def forward(self, x, cache=None, shard=None):
        x = x + self.time_mix(rms_norm(x, self.ln1, self.eps), cache,
                              shard)[0]
        return x + self.channel_mix(rms_norm(x, self.ln2, self.eps), cache)[0]


class MambaBlock(nn.Module):
    """``x + ssm(norm(x))``, as JAX's ``_mamba_block``."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.eps = cfg.norm_eps
        self.ln = nn.Parameter(torch.ones(cfg.d_model))
        self.ssm = Mamba2(cfg)

    def forward(self, x, cache=None, shard=None):
        return x + self.ssm(rms_norm(x, self.ln, self.eps), cache, shard)[0]


class Transformer(nn.Module):
    """The decoder: embed (after any prefix embeddings), the blocks, final
    norm, unembed.  Attention families: the leading dense blocks
    (``dense``), then the stacked ones (``layers``).  RWKV: ``layers`` of
    :class:`RWKVBlock`.  Hybrid: ``n_super`` super-blocks, each ``per``
    :class:`MambaBlock` of ``layers`` and then the one ``shared``
    attention :class:`Block` (with that super-block's own attention
    cache), then the ``tail`` Mamba blocks (:func:`zamba_plan`)."""

    def __init__(self, cfg: ModelConfig, run: RunConfig):
        super().__init__()
        self.cfg, self.run = cfg, run
        #: the mesh and rules the parameters are placed by (DTensors), set
        #: by :func:`~repro_torch.models.convert.from_jax_params`
        self.mesh = self.rules = None
        self.embed = nn.Embedding(cfg.vocab_size, cfg.d_model)
        self.final_ln = nn.Parameter(torch.ones(cfg.d_model))
        if not cfg.tie_embeddings:
            self.unembed = nn.Linear(cfg.d_model, cfg.vocab_size, bias=False)
        first = first_dense_layers(cfg)
        self.dense = nn.ModuleList(Block(cfg, run, use_moe=False)
                                   for _ in range(first))
        if cfg.rwkv is not None:
            self.layers = nn.ModuleList(RWKVBlock(cfg)
                                        for _ in range(cfg.n_layers))
        elif cfg.ssm is not None:
            n_super, per, n_tail = zamba_plan(cfg)
            self.layers = nn.ModuleList(MambaBlock(cfg)
                                        for _ in range(n_super * per))
            self.tail = nn.ModuleList(MambaBlock(cfg) for _ in range(n_tail))
            self.shared = Block(cfg, run, use_moe=False)
        else:
            self.layers = nn.ModuleList(
                Block(cfg, run, use_moe=cfg.moe is not None)
                for _ in range(cfg.n_layers - first))

    def blocks(self) -> list:
        """The config's ``n_layers`` blocks in the order the forward runs
        them (the hybrid's shared block runs between them and is not one
        of them: see :meth:`attention_calls`)."""
        return [*self.dense, *self.layers, *getattr(self, "tail", ())]

    def attention_calls(self) -> list:
        """The attention core of every attention call a forward makes, in
        order: one per attention block, the hybrid's shared core once per
        super-block, none for RWKV.  A prefill launches the flash kernel
        once per entry."""
        if self.cfg.rwkv is not None:
            return []
        if self.cfg.ssm is not None:
            return [self.shared.attn.core] * zamba_plan(self.cfg)[0]
        return [blk.attn.core for blk in self.blocks()]

    def _super_block(self, x, positions, s, cache, cache_pos, shard=None):
        """The hybrid's super-block ``s``: its ``per`` Mamba2 blocks, then
        the shared block with that site's attention cache.  Returns ``(x,
        aux)``."""
        per = self.cfg.ssm.attn_every
        for j in range(per):
            c = None if cache is None else _at(cache["mamba"], s, j)
            x = self._held(self.layers[s * per + j](x, c, shard))
        c = None if cache is None else _at(cache["attn"], s)
        x, _, a = self.shared(x, positions, c, cache_pos, shard)
        return x, a

    def _held(self, x):
        """The residual stream held to ``("batch", "seq", "act_embed")``
        (a no-op without a mesh)."""
        return constrain(x, self.mesh, self.rules,
                         ("batch", "seq", "act_embed"))

    def forward(self, tokens: torch.Tensor, positions: torch.Tensor,
                cache: Optional[dict] = None, cache_pos: int = 0, *,
                prefix_embeds: Optional[torch.Tensor] = None):
        """tokens, positions: (B, T) int32.  ``prefix_embeds`` (B, P, d),
        when given, go before the tokens at positions 0..P-1 and the
        tokens' positions shift by P (the JAX package's vlm stub).
        Returns ``(logits (B, P + T, V) f32, cache, aux)``, as JAX's
        forward: the cache (from :func:`init_cache`) is updated in place
        (attention at slots ``cache_pos`` onward, mod S for a ring; the
        recurrent states and conv inputs overwritten), ``aux`` the MoE
        losses summed over the blocks (f32 scalar).

        Under the mesh and rules the parameters were placed by
        (:attr:`mesh`, :attr:`rules`) the inputs are placed on the batch
        axes, the residual stream is held to ``("batch", "seq",
        "act_embed")`` after the embedding and after every block (JAX's
        constraint after every stacked block, the RWKV body and the
        hybrid's super-block; here also after each Mamba2 block, whose
        output projection leaves a partial sum), and the logits come back
        a DTensor held to ``("batch", "seq", "logit_vocab")``.  Every
        family runs there.  A cache under a mesh is one placed by
        :func:`init_cache` with the mesh and rules (each leaf by
        :func:`cache_logical`); it is written in place, each rank its own
        block."""
        mesh, rules = self.mesh, self.rules
        shard = None if mesh is None else (mesh, rules)
        if shard is not None:
            tokens = distribute(tokens, mesh, rules, ("batch", "seq"))
            positions = distribute(positions, mesh, rules, ("batch", "seq"))
            if prefix_embeds is not None:
                prefix_embeds = distribute(prefix_embeds, mesh, rules,
                                           ("batch", "seq", "act_embed"))
        dtype = getattr(torch, self.run.compute_dtype)
        x = F.embedding(tokens, gathered(self.embed.weight)).to(dtype)
        if prefix_embeds is not None:
            B, P = prefix_embeds.shape[:2]
            x = self._held(x)
            x = torch.cat([prefix_embeds.to(dtype), x], dim=1)
            ppos = torch.arange(P, dtype=torch.int32,
                                device=tokens.device).expand(B, P)
            if shard is not None:
                ppos = distribute(ppos, mesh, rules, ("batch", "seq"))
            positions = torch.cat([ppos, positions + P], dim=1)
        x = self._held(x)
        aux = torch.zeros((), device=x.device)
        mode = self.run.remat if cache is None else "none"
        if self.cfg.rwkv is not None:
            for i, block in enumerate(self.layers):
                x = self._held(remat(block, mode)(
                    x, None if cache is None else _at(cache, i), shard))
        elif self.cfg.ssm is not None:
            for s in range(zamba_plan(self.cfg)[0]):
                x, a = remat(self._super_block, mode)(x, positions, s, cache,
                                                      cache_pos, shard)
                x = self._held(x)
                aux = aux + a
            for t, block in enumerate(self.tail):
                x = self._held(block(x, None if cache is None
                                     else cache["tail"][t], shard))
        else:
            for i, block in enumerate(self.dense):
                c = None if cache is None else cache[f"dense{i}"]
                x, _, a = block(x, positions, c, cache_pos, shard)
                x = self._held(x)
                aux = aux + a
            for i, block in enumerate(self.layers):
                c = None if cache is None else _at(cache["layers"], i)
                x, _, a = remat(block, mode)(x, positions, c, cache_pos,
                                             shard)
                x = self._held(x)
                aux = aux + a
        x = rms_norm(x, self.final_ln, self.cfg.norm_eps)
        w = gathered(self.embed.weight if self.cfg.tie_embeddings
                     else self.unembed.weight)
        logits = constrain(F.linear(x.float(), w.float()), mesh, rules,
                           ("batch", "seq", "logit_vocab"))
        return logits, cache, aux
