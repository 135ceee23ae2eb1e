"""Serving steps: batched prefill and single-token decode over the cache.

Counterpart of :mod:`repro.serve.decode`, with the same contracts; the
weights are the :class:`~repro_torch.models.transformer.Transformer`
passed where JAX passes ``params``.  Each step runs without autograd.
The cache (the tree :func:`~repro_torch.models.transformer.init_cache`
makes: attention slots, or the recurrent families' states and last
inputs, or both for the hybrid) is updated in place and also returned, as
JAX returns its new cache.  A prefill into the cache starts from the
recurrent states it holds, so a new prompt takes a fresh cache.  The MoE loss the forward also returns is dropped here, as JAX's
steps drop it; ``model(tokens, positions, ...)`` gives it.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..config.base import ModelConfig, RunConfig
from ..models.transformer import Transformer
from ..sharding.rules import check_placed, is_dtensor


def _checked(model: Transformer, cfg: ModelConfig, run: RunConfig):
    if model.cfg != cfg or model.run != run:
        raise ValueError(f"the step was built for ({cfg}, {run}), the model "
                         f"for ({model.cfg}, {model.run})")


def _arange_positions(B: int, T: int, device) -> torch.Tensor:
    """(B, T) int32 positions 0..T-1, contiguous (the flash kernel's
    layout)."""
    return torch.arange(T, dtype=torch.int32, device=device).repeat(B, 1)


def _whole(t: torch.Tensor) -> torch.Tensor:
    """A DTensor gathered whole on every rank; a plain tensor as it is."""
    return t.full_tensor() if is_dtensor(t) else t


def make_prefill_step(cfg: ModelConfig, run: RunConfig, mesh=None,
                      rules=None):
    """The cacheless prefill step: ``(model, tokens[, positions,
    prefix_embeds]) -> logits`` over a (B, T) prompt batch; ``prefix_embeds``
    (B, P, d) go first, at positions 0..P-1, and the logits are (B, P + T,
    V).  Use :func:`make_prefill_cache_step` when decode will follow.

    With ``mesh`` and ``rules`` (the model placed by them) the prompt
    batch is placed on the batch axes and the logits are the whole
    (B, P + T, V) tensor on every rank (gathered from their
    ``("batch", "seq", "logit_vocab")`` shards)."""

    @torch.inference_mode()
    def prefill_step(model: Transformer, tokens: torch.Tensor,
                     positions: Optional[torch.Tensor] = None,
                     prefix_embeds: Optional[torch.Tensor] = None):
        _checked(model, cfg, run)
        check_placed(model, mesh, rules)
        if positions is None:
            positions = _arange_positions(*tokens.shape, tokens.device)
        return _whole(model(tokens, positions,
                            prefix_embeds=prefix_embeds)[0])

    return prefill_step


def make_prefill_cache_step(cfg: ModelConfig, run: RunConfig, mesh=None,
                            rules=None):
    """Prefill that also fills the decode cache from slot 0:
    ``(model, tokens, cache[, prefix_embeds]) -> (logits (B, P + T, V),
    cache)``.  The prefix fills slots 0..P-1, so decode goes on at
    ``cache_pos = P + T``.

    With ``mesh`` and ``rules`` (the model placed by them, the cache by
    :func:`~repro_torch.models.transformer.init_cache` with them: rules
    from :func:`~repro_torch.launch.specs.serve_rules`) each rank writes
    its own block of every cache leaf, and the logits are the whole
    tensor on every rank."""

    @torch.inference_mode()
    def prefill(model: Transformer, tokens: torch.Tensor, cache,
                prefix_embeds: Optional[torch.Tensor] = None):
        _checked(model, cfg, run)
        check_placed(model, mesh, rules)
        positions = _arange_positions(*tokens.shape, tokens.device)
        logits, cache, _ = model(tokens, positions, cache=cache, cache_pos=0,
                                 prefix_embeds=prefix_embeds)
        return _whole(logits), cache

    return prefill


def make_serve_step(cfg: ModelConfig, run: RunConfig, mesh=None,
                    rules=None, *, greedy: bool = True):
    """The single-token decode step: ``(model, cache, tokens, cache_pos[,
    generator]) -> (next (B, 1) int32, cache, logits (B, V))``.

    ``tokens`` (B, 1) is the newest token, ``cache_pos`` (an int) its
    position.  ``greedy=False`` with a ``torch.Generator`` samples from
    the softmax of the logits instead of taking the argmax.  With
    ``mesh`` and ``rules`` (as :func:`make_prefill_cache_step`'s) the step
    writes each rank's block of the cache and every rank gets the whole
    logits and the same next tokens.
    """

    @torch.inference_mode()
    def serve_step(model: Transformer, cache, tokens: torch.Tensor,
                   cache_pos: int,
                   generator: Optional[torch.Generator] = None):
        _checked(model, cfg, run)
        check_placed(model, mesh, rules)
        B = tokens.shape[0]
        positions = torch.full((B, 1), cache_pos, dtype=torch.int32,
                               device=tokens.device)
        logits, cache, _ = model(tokens, positions, cache=cache,
                                 cache_pos=cache_pos)
        logits = _whole(logits[:, -1])
        if greedy or generator is None:
            nxt = logits.argmax(-1)
        else:
            nxt = torch.multinomial(torch.softmax(logits, -1), 1,
                                    generator=generator)[:, 0]
        return nxt.to(torch.int32)[:, None], cache, logits

    return serve_step
