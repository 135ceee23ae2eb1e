"""The flash-attention kernel: wrapper around the hand-written CUDA kernel
(``csrc/flash_attention.cu``) with its plain torch version beside it.

Counterpart of :mod:`repro.kernels.flash_attention` (the Pallas TPU
kernel).  A CUDA tensor launches the CUDA kernel or raises; a CPU tensor
runs the plain version (:func:`repro_torch.kernels.ref.flash_attention_ref`).
There is no other path.

Under autograd (grad mode on and q, k or v requiring grad) the call goes
through :class:`FlashAttentionFunction`: the same forward, and a backward
that recomputes the attention through the port's ``"chunked_causal"``
twin (:func:`repro_torch.models.attention._chunked_attention`, each query
row checkpointed) and differentiates it.  That is the gradient the JAX
package computes (its ``"pallas"`` impl falls back to the same twin under
``jax.grad``: the Pallas kernel has no backward); there is no backward
kernel.  A block recomputed by ``torch.utils.checkpoint`` does not launch
the kernel again: :func:`keep_outputs` (the checkpoint's ``context_fn``)
records each launch's output in the forward and hands them back, in
order, to the recompute; and the launch is the operator
``repro_torch::flash_attention`` (:func:`flash_attention_op`), which
selective checkpointing can name to keep its output.
"""
from __future__ import annotations

import ctypes
import functools
import threading
from typing import Optional

import torch

from . import _build
from .ref import flash_attention_ref

#: head dims the kernel is built for: every attention config of the repo,
#: full and smoke size (MLA's qk head dim nope + rope is 192 and 24)
HEAD_DIMS = (16, 24, 32, 64, 120, 128, 192)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_launch.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i,
                                           i, i, p]
    lib.flash_attention_launch.restype = i
    lib.flash_attention_error_string.argtypes = [i]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def _check(q, k, v, q_pos, kv_pos, window):
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError("flash_attention takes q (B, T, H, D) and k, v "
                         f"(B, S, Hkv, D), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, T, H, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"k, v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if Hkv == 0 or H % Hkv:
        raise ValueError(f"H={H} is not a multiple of Hkv={Hkv}")
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} not supported; the kernel takes "
                         f"{HEAD_DIMS}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"flash_attention takes float32 or bfloat16, got "
                         f"{q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must share one dtype, got {q.dtype}, "
                         f"{k.dtype}, {v.dtype}")
    if q_pos.shape != (B, T) or kv_pos.shape != (B, S):
        raise ValueError(f"positions must be ({B}, {T}) and ({B}, {S}), got "
                         f"{tuple(q_pos.shape)} and {tuple(kv_pos.shape)}")
    if q_pos.dtype != torch.int32 or kv_pos.dtype != torch.int32:
        raise ValueError("positions must be int32")
    for t in (k, v, q_pos, kv_pos):
        if t.device != q.device:
            raise ValueError(f"all inputs must be on {q.device}, got "
                             f"{t.device}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 or None, got {window}")


def flash_attention(q, k, v, q_pos, kv_pos, *,
                    window: Optional[int] = None,
                    chunk: int = 1024) -> torch.Tensor:
    """Causal (optionally windowed) GQA attention with an online softmax.

    q: (B, T, H, D); k, v: (B, S, Hkv, D), float32 or bfloat16; q_pos
    (B, T) and kv_pos (B, S) int32.  Key j is visible to query i iff
    ``kv_pos[j] <= q_pos[i]`` (and ``kv_pos[j] > q_pos[i] - window``).
    Returns (B, T, H, D) in q's dtype.  With grad mode on and q, k or v
    requiring grad the output has a ``grad_fn``
    (:class:`FlashAttentionFunction`; ``chunk`` is its backward's kv and
    query block).  ``flash_attention.launches`` counts CUDA kernel
    launches (forward only: the backward launches none).
    """
    _check(q, k, v, q_pos, kv_pos, window)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttentionFunction.apply(q, k, v, q_pos, kv_pos, window,
                                            chunk)
    return _forward(q, k, v, q_pos, kv_pos, window)


def _forward(q, k, v, q_pos, kv_pos, window):
    """The kernel on a CUDA tensor, the plain version on a CPU tensor."""
    dev = q.device
    if dev.type == "cpu":
        return flash_attention_ref(q, k, v, q_pos, kv_pos, window=window)
    if dev.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not {dev}")
    for t in (q, k, v, q_pos, kv_pos):
        if not t.is_contiguous() or t.data_ptr() % (16 if t.dim() == 4
                                                    else 4):
            raise ValueError("flash_attention takes contiguous CUDA tensors,"
                             " q, k and v 16-byte aligned")
    B, T, H, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(),
            kv_pos.data_ptr(), out.data_ptr(), B, T, S, H, Hkv, D,
            window or 0, int(q.dtype == torch.bfloat16), stream)
    if err:
        raise RuntimeError("flash_attention launch failed: "
                           + lib.flash_attention_error_string(err).decode())
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       q_pos: torch.Tensor, kv_pos: torch.Tensor,
                       window: int) -> torch.Tensor:
    """The forward launch as an operator (``window`` 0 = none), the one
    :class:`FlashAttentionFunction` calls: a checkpoint policy names it
    (``torch.ops.repro_torch.flash_attention.default``) to keep its
    output."""
    return _forward(q, k, v, q_pos, kv_pos, window or None)


#: per thread: None, or ("record", outputs) while a checkpointed forward
#: runs, or ("replay", outputs, cursor) while the checkpoint recomputes it
_kept = threading.local()


class _Keeping:
    """Sets the thread's :data:`_kept` state while entered; can be entered
    any number of times (a checkpoint recomputes once per backward that
    reaches it), and each replay entry starts at the first output."""

    def __init__(self, mode, outputs):
        self.mode, self.outputs, self.prev = mode, outputs, []

    def __enter__(self):
        self.prev.append(getattr(_kept, "state", None))
        _kept.state = ((self.mode, self.outputs) if self.mode == "record"
                       else (self.mode, self.outputs, [0]))

    def __exit__(self, *exc):
        _kept.state = self.prev.pop()


def keep_outputs():
    """``(forward, recompute)`` context managers for the ``context_fn`` of
    ``torch.utils.checkpoint`` (non-reentrant): under the first each
    :class:`FlashAttentionFunction` forward records its output; under
    the second, the recompute, each takes the recorded outputs back in
    order instead of launching, from the first again at every recompute
    (a second backward through the same graph recomputes again).  The
    outputs stay alive as long as the checkpoint's saved state does (one
    (B, T, H, D) tensor a call)."""
    outputs: list = []
    return _Keeping("record", outputs), _Keeping("replay", outputs)


class FlashAttentionFunction(torch.autograd.Function):
    """:func:`flash_attention` under autograd.

    Forward: the kernel (a CPU tensor: the plain version) through
    :func:`flash_attention_op`, or, in a checkpoint's recompute under
    :func:`keep_outputs`, the output the forward recorded; saves q, k, v
    and the positions.
    Backward: recomputes the attention under ``torch.enable_grad()``
    through the ``"chunked_causal"`` twin at ``chunk`` (query rows
    checkpointed, so it holds O(T * chunk) scores, not O(T^2)) and returns
    ``torch.autograd.grad`` of it: the gradient JAX takes of the same
    twin.  No kernel is launched in the backward."""

    @staticmethod
    def forward(ctx, q, k, v, q_pos, kv_pos, window, chunk):
        ctx.save_for_backward(q, k, v, q_pos, kv_pos)
        ctx.window, ctx.chunk = window, chunk
        state = getattr(_kept, "state", None)
        if state is not None and state[0] == "replay":
            cursor = state[2]
            cursor[0] += 1
            return state[1][cursor[0] - 1].detach()
        out = torch.ops.repro_torch.flash_attention(q, k, v, q_pos, kv_pos,
                                                    window or 0)
        if state is not None:
            state[1].append(out.detach())
        return out

    @staticmethod
    def backward(ctx, grad_out):
        from ..models.attention import _chunked_attention

        q, k, v, q_pos, kv_pos = ctx.saved_tensors
        wanted = ctx.needs_input_grad[:3]
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(w)
                   for t, w in zip((q, k, v), wanted)]
            out = _chunked_attention(*ins, q_pos, kv_pos, ctx.window,
                                     ctx.chunk, triangular=True,
                                     remat_rows=True)
            grads = iter(torch.autograd.grad(
                out, [t for t in ins if t.requires_grad], grad_out))
        return (*(next(grads) if w else None for w in wanted), None, None,
                None, None)
