"""Train-step factory: the CE loss, microbatch accumulation, the int8
gradient round trip and AdamW.

Counterpart of :mod:`repro.train.train_step`, with JAX's loss exactly:
the ``(B, T + 1)`` tokens split into inputs and labels, positions
``0..T-1`` unless the batch gives them, a prefix's logits dropped, f32
log-softmax cross entropy plus the forward's ``aux`` (the MoE losses).
Remat is the model's own (``run.remat``, per block); the gradients come
from ``torch.autograd.grad``, the update from
:func:`repro_torch.train.optimizer.adamw_update`, in place.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..config.base import ModelConfig, RunConfig
from ..models.convert import jax_slot
from ..models.transformer import Transformer
from ..sharding.rules import (check_placed, constrain, distribute,
                              is_dtensor, placed_as)
from .optimizer import OptState, adamw_update, compress_grads_int8

#: the int8 round trip's noise seed for update ``step``: JAX folds the step
#: into ``PRNGKey(17)``
_NOISE_SEED = 17 << 32


def make_loss_fn(cfg: ModelConfig, run: RunConfig, mesh=None, rules=None):
    """``loss_fn(model, batch) -> (loss, {"ce", "aux"})``; ``batch`` holds
    ``"tokens"`` (B, T + 1) int and optionally ``"positions"`` (B, T) int32
    and ``"prefix_embeds"`` (B, P, d).

    With ``mesh`` and ``rules`` (the model placed by them:
    :func:`~repro_torch.models.convert.from_jax_params`) the batch is
    placed on the batch axes, the vocab-sharded logits are gathered over
    the model axis before the log-softmax, and the loss is the whole
    batch's mean, the same 0-d tensor on every rank."""

    def loss_fn(model: Transformer, batch: dict):
        if model.cfg != cfg or model.run != run:
            raise ValueError(f"the loss was built for ({cfg}, {run}), the "
                             f"model for ({model.cfg}, {model.run})")
        check_placed(model, mesh, rules)
        tokens = batch["tokens"]
        inputs, labels = tokens[:, :-1], tokens[:, 1:]
        if mesh is not None:  # each rank's rows, contiguous
            inputs, labels = (distribute(t.contiguous(), mesh, rules,
                                         ("batch", "seq"))
                              for t in (inputs, labels))
        B, T = inputs.shape
        positions = batch.get("positions")
        if positions is None:
            positions = torch.arange(T, dtype=torch.int32,
                                     device=tokens.device).repeat(B, 1)
        prefix = batch.get("prefix_embeds")
        logits, _, aux = model(inputs, positions, prefix_embeds=prefix)
        if prefix is not None:
            logits = logits[:, prefix.shape[1]:]
        logits = constrain(logits, mesh, rules, ("batch", "seq", None))
        logp = torch.log_softmax(logits.float(), dim=-1)
        ll = logp.gather(-1, labels[..., None].long())[..., 0]
        ce = -ll.mean()
        if is_dtensor(ce):
            ce = ce.full_tensor()
        return ce + aux, {"ce": ce, "aux": aux}

    return loss_fn


def _grads(loss_fn, model: Transformer, batch: dict):
    """(loss, metrics, {name: gradient}) of one batch; a parameter the loss
    does not reach gets zeros, as JAX's gradient has.  A DTensor
    parameter's gradient comes back placed as the parameter (a partial
    sum reduce-scattered or all-reduced)."""
    names, params = zip(*model.named_parameters())
    loss, mets = loss_fn(model, batch)
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return loss.detach(), {k: v.detach() for k, v in mets.items()}, {
        k: torch.zeros_like(p) if g is None else placed_as(g, p)
        for k, p, g in zip(names, params, grads)}


def make_grad_fn(cfg: ModelConfig, run: RunConfig, mesh=None, rules=None,
                 *, microbatch: Optional[int] = None):
    """``grad_fn(model, batch) -> (loss, metrics, grads)``, JAX's
    ``value_and_grad`` of the loss with the train step's microbatching:
    ``microbatch`` (default ``run.microbatch``) > 1 splits every batch
    entry into that many equal row slices, accumulates their gradients in
    f32 and averages them (and the loss and metrics), as JAX's scan does.
    ``grads`` is keyed by the module's parameter names."""
    loss_fn = make_loss_fn(cfg, run, mesh, rules)
    n = microbatch if microbatch is not None else (run.microbatch or 1)

    def grad_fn(model: Transformer, batch: dict):
        if n == 1:
            return _grads(loss_fn, model, batch)
        rows = batch["tokens"].shape[0]
        if rows % n:
            raise ValueError(f"batch of {rows} rows does not split into {n} "
                             "microbatches")
        per = rows // n
        gsum, lsum, msum = None, 0.0, {}
        for i in range(n):
            mb = {k: v[i * per:(i + 1) * per] for k, v in batch.items()}
            loss, mets, grads = _grads(loss_fn, model, mb)
            if gsum is None:
                gsum = {k: g.float() for k, g in grads.items()}
            else:
                torch._foreach_add_(list(gsum.values()),
                                    [grads[k] for k in gsum])
            del grads
            lsum = lsum + loss
            msum = {k: msum.get(k, 0.0) + v for k, v in mets.items()}
        torch._foreach_div_(list(gsum.values()), n)
        return lsum / n, {k: v / n for k, v in msum.items()}, gsum

    return grad_fn


def make_train_step(cfg: ModelConfig, run: RunConfig, mesh=None,
                    rules=None, *, microbatch: Optional[int] = None,
                    total_steps: int = 10_000, warmup: int = 100):
    """``train_step(model, opt, batch) -> (model, opt, metrics)``.

    The gradients come from :func:`make_grad_fn` (``microbatch`` as
    there).  With ``run.grad_compression == "int8"`` they take the int8
    round trip (:func:`compress_grads_int8`, noise from a generator seeded
    by the step, so a resumed run draws the same noise) with one scale
    for each JAX key, a ``layers/`` stack included, as JAX's (on a
    sharded model, on each rank's shards).  The model's
    parameters and ``opt``'s moments are updated in place; ``metrics``
    holds ``loss``, ``ce``, ``aux``, ``grad_norm`` (0-d tensors, no sync)
    and ``lr``.

    With ``mesh`` and ``rules`` the model's parameters and ``opt``'s
    moments are DTensors placed by them, each gradient comes back placed
    as its parameter, and the update runs on each rank's shards (the
    clip norm is the global one: :func:`~repro_torch.train.optimizer.
    adamw_update`)."""
    grad_fn = make_grad_fn(cfg, run, mesh, rules, microbatch=microbatch)

    def train_step(model: Transformer, opt: OptState, batch: dict):
        loss, metrics, grads = grad_fn(model, batch)
        if run.grad_compression == "int8":
            device = batch["tokens"].device
            gen = torch.Generator(device=device).manual_seed(
                _NOISE_SEED + opt.step)
            grads = compress_grads_int8(
                grads, gen, slots={k: jax_slot(k) for k in grads})
        opt, opt_mets = adamw_update(dict(model.named_parameters()), grads,
                                     opt, run, total_steps=total_steps,
                                     warmup=warmup)
        return model, opt, {**metrics, **opt_mets, "loss": loss}

    return train_step
