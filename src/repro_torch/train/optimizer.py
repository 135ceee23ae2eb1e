"""AdamW with decoupled weight decay, global-norm clipping, cosine schedule,
and the int8 gradient round trip.

Counterpart of :mod:`repro.train.optimizer`, with the same arithmetic in
f32: the schedule and the bias corrections as f32 scalars (numpy, as
JAX's f32 arrays), the moments f32 tensors.  Unlike JAX's pure update,
:func:`adamw_update` writes the new values into the parameters and the
moments in place (and scales the gradients in place when it clips), so a
step holds no second copy of the model.  Trees are dicts keyed by the
module's parameter names; the decay mask reads each name's JAX key
(:func:`repro_torch.models.convert.jax_key_of`), since the JAX names
(``mu_``, ``/u``, ``/D``, ``A_log``, ``dt_bias``) are what it matches.
"""
from __future__ import annotations

from typing import Mapping, NamedTuple, Optional

import numpy as np
import torch

from ..config.base import RunConfig
from ..models.convert import jax_key_of

#: temporaries of one foreach group of the update, in elements (1 GiB f32)
_GROUP_ELEMS = 2**28


class OptState(NamedTuple):
    step: int  # updates taken
    m: dict  # name -> f32 first moment
    v: dict  # name -> f32 second moment


def adamw_init(params: Mapping[str, torch.Tensor]) -> OptState:
    """Zero f32 moments of each parameter's shape, on its device."""
    def zeros():
        return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for k, p in params.items()}

    return OptState(step=0, m=zeros(), v=zeros())


def cosine_schedule(step, base_lr, warmup=100, total=10_000, min_frac=0.1):
    """JAX's schedule in f32: linear warmup to ``base_lr``, then a cosine
    down to ``min_frac * base_lr`` at ``total``.  Returns an f32 scalar."""
    f32 = np.float32
    step, base_lr = f32(step), f32(base_lr)
    warm = base_lr * step / f32(warmup)
    prog = np.clip((step - f32(warmup)) / f32(max(total - warmup, 1)),
                   f32(0), f32(1))
    cos = f32(min_frac) + f32(1 - min_frac) * f32(0.5) * (
        f32(1) + np.cos(f32(np.pi) * prog))
    return warm if step < warmup else base_lr * cos


def global_norm(tree: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32 (a 0-d tensor on
    the leaves' device)."""
    norms = torch._foreach_norm([g.float() for g in tree.values()])
    return torch.linalg.vector_norm(torch.stack(norms))


def clip_by_global_norm(grads: Mapping[str, torch.Tensor], max_norm: float):
    """Scale ``grads`` in place by ``min(1, max_norm / norm)``; returns
    ``(grads, norm)``.  The scale stays on the device (no sync)."""
    norm = global_norm(grads)
    scale = (max_norm / norm.clamp(min=1e-9)).clamp(max=1.0)
    torch._foreach_mul_(list(grads.values()), scale)
    return grads, norm


_NO_DECAY_SUBSTRINGS = ("ln", "norm", "bias", "b_", "/b", "mu_", "A_log",
                        "dt_bias", "/u", "/D")


def _decay_mask(path: str) -> bool:
    """Whether the JAX key ``path`` takes weight decay (JAX's rule)."""
    return not any(s in path for s in _NO_DECAY_SUBSTRINGS)


def _groups(names, params):
    """``names`` split into runs of at most ``_GROUP_ELEMS`` elements (a
    larger tensor alone), bounding the update's temporaries."""
    group, size = [], 0
    for k in names:
        n = params[k].numel()
        if group and size + n > _GROUP_ELEMS:
            yield group
            group, size = [], 0
        group.append(k)
        size += n
    if group:
        yield group


@torch.no_grad()
def adamw_update(params: Mapping[str, torch.Tensor],
                 grads: Mapping[str, torch.Tensor], opt: OptState,
                 run: RunConfig, *, total_steps: int = 10_000,
                 warmup: int = 100):
    """One AdamW step, as JAX's: clip the gradients by global norm
    (``run.grad_clip``), then for each parameter

        m = b1 m + (1 - b1) g;   v = b2 v + (1 - b2) g^2
        upd = (m / bc1) / (sqrt(v / bc2) + 1e-8) [+ wd * p where decayed]
        p = p - lr * upd

    with ``lr`` from :func:`cosine_schedule` at the new step.  ``params``
    are updated in place, and so are ``opt``'s moments and the gradients
    (clipped).  Returns ``(opt, {"grad_norm": 0-d tensor, "lr": float})``.
    """
    grads, gnorm = clip_by_global_norm(grads, run.grad_clip)
    step = opt.step + 1
    lr = cosine_schedule(step, run.learning_rate, total=total_steps,
                         warmup=warmup)
    f32 = np.float32
    b1, b2 = run.adam_b1, run.adam_b2
    bc1 = float(f32(1) - f32(b1) ** f32(step))
    bc2 = float(f32(1) - f32(b2) ** f32(step))
    for names in _groups(list(params), params):
        p = [params[k] for k in names]
        p32 = [t if t.dtype == torch.float32 else t.float() for t in p]
        g = [grads[k].float() for k in names]
        m = [opt.m[k] for k in names]
        v = [opt.v[k] for k in names]
        torch._foreach_mul_(m, b1)
        torch._foreach_add_(m, g, alpha=1 - b1)
        torch._foreach_mul_(v, b2)
        torch._foreach_addcmul_(v, g, g, value=1 - b2)
        denom = torch._foreach_div(v, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, 1e-8)
        upd = torch._foreach_div(m, bc1)
        torch._foreach_div_(upd, denom)
        del denom
        decayed = [i for i, k in enumerate(names)
                   if _decay_mask(jax_key_of(k))]
        if decayed and run.weight_decay:
            torch._foreach_add_([upd[i] for i in decayed],
                                [p32[i] for i in decayed],
                                alpha=run.weight_decay)
        torch._foreach_add_(p32, upd, alpha=-float(lr))
        for t, t32 in zip(p, p32):
            if t is not t32:
                t.copy_(t32)
    return OptState(step=step, m=opt.m, v=opt.v), {"grad_norm": gnorm,
                                                   "lr": float(lr)}


def compress_grads_int8(grads: Mapping[str, torch.Tensor],
                        generator: Optional[torch.Generator] = None,
                        noise: Optional[Mapping[str, torch.Tensor]] = None
                        ) -> dict:
    """Per-tensor int8 quantization round trip with stochastic rounding,
    as JAX's: ``scale = max(|g|) / 127`` (at least 1e-12 / 127), ``q =
    clip(round(g / scale + noise), -127, 127)`` as int8, back to
    ``q * scale`` in f32.  ``noise`` (the same keys; uniform on [-0.5,
    0.5)) is drawn from ``generator`` in sorted key order unless given:
    JAX draws it with ``jax.random``, whose bits torch cannot reproduce,
    so a parity check hands both the same noise."""
    out = {}
    for k in sorted(grads):
        g = grads[k].float()
        scale = g.abs().max().clamp(min=1e-12) / 127.0
        if noise is not None:
            n = noise[k].to(g.device, torch.float32)
        else:
            n = torch.rand(g.shape, generator=generator, device=g.device,
                           dtype=torch.float32) - 0.5
        q = torch.clamp(torch.round(g / scale + n), -127, 127).to(torch.int8)
        out[k] = q.float() * scale
    return out
