"""The flash-attention kernel: wrapper around the hand-written CUDA kernel
(``csrc/flash_attention.cu``) with its plain torch version beside it.

Counterpart of :mod:`repro.kernels.flash_attention` (the Pallas TPU
kernel).  A CUDA tensor launches the CUDA kernel or raises; a CPU tensor
runs the plain version (:func:`repro_torch.kernels.ref.flash_attention_ref`).
There is no other path.
"""
from __future__ import annotations

import ctypes
import functools
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
                    window: Optional[int] = None) -> torch.Tensor:
    """Causal (optionally windowed) GQA attention with an online softmax.

    q: (B, T, H, D); k, v: (B, S, Hkv, D), float32 or bfloat16; q_pos
    (B, T) and kv_pos (B, S) int32.  Key j is visible to query i iff
    ``kv_pos[j] <= q_pos[i]`` (and ``kv_pos[j] > q_pos[i] - window``).
    Returns (B, T, H, D) in q's dtype.  ``flash_attention.launches``
    counts CUDA kernel launches.
    """
    _check(q, k, v, q_pos, kv_pos, window)
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
