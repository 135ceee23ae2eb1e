"""The triad-census tile kernel: wrapper around the hand-written CUDA kernel
(``csrc/census_tiles.cu``) with its plain torch version beside it.

Counterpart of :mod:`repro.kernels.triad_census` (the Pallas TPU kernel).
A CUDA tensor launches the CUDA kernel or raises; a CPU tensor runs the
plain version (:func:`repro_torch.kernels.ref.census_tiles_ref`).  There
is no other path.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .ref import census_tiles_ref

SENTINEL = 2**30


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("census_tiles")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.census_tiles_launch.argtypes = [p, p, ll, p, p, p, p, p, p, i, i, i,
                                        p, p]
    lib.census_tiles_launch.restype = i
    lib.census_tiles_error_string.argtypes = [i]
    lib.census_tiles_error_string.restype = ctypes.c_char_p
    return lib


def _check(u, v, n, tiles, block):
    if block < 1:
        raise ValueError(f"block must be >= 1, got {block}")
    if tiles[0].dim() != 2:
        raise ValueError(f"tiles must be (D, K), got {tuple(tiles[0].shape)}")
    D = tiles[0].shape[0]
    for t in (*tiles, u, v):
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError("census_tiles takes contiguous int32 tensors, "
                             f"got {t.dtype} (contiguous={t.is_contiguous()})")
        if t.device != u.device:
            raise ValueError(f"all inputs must be on {u.device}, "
                             f"got {t.device}")
    if any(t.shape != tiles[0].shape for t in tiles):
        raise ValueError("the six tiles must share one (D, K) shape, got "
                         f"{[tuple(t.shape) for t in tiles]}")
    if u.shape != (D,) or v.shape != (D,):
        raise ValueError(f"u and v must be ({D},), got {tuple(u.shape)} and "
                         f"{tuple(v.shape)}")
    if D % block:
        raise ValueError(f"D={D} is not a multiple of block={block}")
    if not 0 <= block * n < 2**30:
        raise ValueError(f"block * n = {block * n} must stay below 2**30 so "
                         "each int32 partial row is exact")


def census_tiles(u, v, n: int, out_u, in_u, out_v, in_v, nbr_u, nbr_v, *,
                 block: int = 32) -> torch.Tensor:
    """Census of dyadic + connected triads over (D, K) neighbourhood tiles.

    ``u``, ``v``: (D,) int32 canonical dyads, ``u == SENTINEL`` marking a
    padded dyad; the six tiles are (D, K) int32 rows sorted ascending with
    a SENTINEL tail (what :func:`repro_torch.kernels.ops.gather_tiles_device`
    gives).  Returns (D / block, 16) int32 partials, one row per ``block``
    dyads, for the caller to fold into a wider accumulator.
    ``census_tiles.launches`` counts CUDA kernel launches.
    """
    tiles = (out_u, in_u, out_v, in_v, nbr_u, nbr_v)
    _check(u, v, n, tiles, block)
    dev = u.device
    if dev.type == "cpu":
        return census_tiles_ref(*tiles, u, v, n, block=block)
    if dev.type != "cuda":
        raise ValueError(f"census_tiles runs on cuda or cpu, not {dev}")
    D, K = nbr_u.shape
    out = torch.empty((D // block, 16), dtype=torch.int32, device=dev)
    if D == 0:
        return out
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.census_tiles_launch(
            u.data_ptr(), v.data_ptr(), n, *(t.data_ptr() for t in tiles),
            D, K, block, out.data_ptr(), stream)
    if err:
        raise RuntimeError("census_tiles launch failed: "
                           + lib.census_tiles_error_string(err).decode())
    census_tiles.launches += 1
    return out


census_tiles.launches = 0
