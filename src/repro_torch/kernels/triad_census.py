"""The triad-census kernels: wrappers around the hand-written CUDA kernels
with their plain torch versions beside them.

Counterparts of :mod:`repro.kernels.triad_census` (the Pallas TPU kernel):

* :func:`census_csr` (``csrc/census_csr.cu``) reads the CSR rows of each
  dyad directly and is the census main path's kernel;
* :func:`census_tiles` (``csrc/census_tiles.cu``) takes the Pallas
  kernel's own six-tile interface: the parity seam, off the main path.

A CUDA tensor launches the CUDA kernel or raises; a CPU tensor runs the
plain version (:mod:`repro_torch.kernels.ref`).  There is no other path.
"""
from __future__ import annotations

import ctypes
import functools
import threading

import torch

from ..core import spans
from . import _build
from .ref import census_csr_ref, census_tiles_ref

SENTINEL = 2**30
# the executor's pool workers launch from several threads: the launch
# counters' read-modify-write takes this lock
_COUNT_LOCK = threading.Lock()


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


def _check_block(n, block):
    if block < 1:
        raise ValueError(f"block must be >= 1, got {block}")
    if not 0 <= block * n < 2**30:
        raise ValueError(f"block * n = {block * n} must stay below 2**30 so "
                         "each int32 partial row is exact")


def _check(u, v, n, tiles, block):
    _check_block(n, block)
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


@functools.lru_cache(maxsize=None)
def _csr_lib() -> ctypes.CDLL:
    lib = _build.load("census_csr")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.census_csr_launch.argtypes = [p, p, ll, p, p, p, p, i, i, i, i, i, p,
                                      p]
    lib.census_csr_launch.restype = i
    lib.census_csr_error_string.argtypes = [i]
    lib.census_csr_error_string.restype = ctypes.c_char_p
    return lib


def _check_csr(u, v, n, arrays, block):
    _check_block(n, block)
    if arrays.nbr_flag is None or arrays.nbr_cnt is None:
        raise ValueError("arrays must carry nbr_flag and nbr_cnt "
                         "(Plan.padded_arrays(g, with_flags=True))")
    want = dict(u=(u, torch.int32), v=(v, torch.int32),
                nbr_ptr=(arrays.nbr_ptr, torch.int32),
                nbr_idx=(arrays.nbr_idx, torch.int32),
                nbr_flag=(arrays.nbr_flag, torch.int8),
                nbr_cnt=(arrays.nbr_cnt, torch.int32))
    for name, (t, dtype) in want.items():
        if (t.dtype != dtype or not t.is_contiguous()
                or (t.dim() != 1 and name != "nbr_cnt")):
            raise ValueError(f"{name} must be a contiguous 1-D {dtype} "
                             f"tensor, got {t.dtype} {tuple(t.shape)} "
                             f"(contiguous={t.is_contiguous()})")
        if t.device != u.device:
            raise ValueError(f"all inputs must be on {u.device}, "
                             f"{name} is on {t.device}")
    M = arrays.nbr_idx.shape[0]
    if arrays.nbr_flag.shape != (M,):
        raise ValueError(f"nbr_flag must have nbr_idx's length {M}, got "
                         f"{tuple(arrays.nbr_flag.shape)}")
    if arrays.nbr_cnt.shape not in ((M,), (2, M)):
        raise ValueError(f"nbr_cnt must have nbr_idx's length {M}, packed "
                         f"({M},) or wide (2, {M}), got "
                         f"{tuple(arrays.nbr_cnt.shape)}")
    D = u.shape[0]
    if v.shape != (D,):
        raise ValueError(f"u and v must be ({D},), got {tuple(u.shape)} and "
                         f"{tuple(v.shape)}")
    if D % block:
        raise ValueError(f"D={D} is not a multiple of block={block}")


def census_csr(u, v, n: int, arrays, *, k: int,
               block: int = 32) -> torch.Tensor:
    """Census of dyadic + connected triads read straight from the CSR.

    ``u``, ``v``: (D,) int32 canonical dyads, ``u == SENTINEL`` marking a
    padded dyad; ``arrays``: the graph's
    :class:`~repro_torch.core.graph.GraphArrays` with the arc flags and
    range counts (``Plan.padded_arrays(g, with_flags=True)``).  ``k``
    bounds every row of the dyads, ``max(deg u, deg v)`` (the tiles
    backend passes its bucket width): up to 512 the kernel maps one warp
    to a dyad, above it one CTA to a group of dyads.  Returns the
    (D / block, 16) int32 partials :func:`census_tiles` gives for the same
    dyads.  ``census_csr.launches`` counts CUDA kernel launches.  The
    checks and the launch are the ``census.check`` and ``census.launch``
    spans while a profiler records (:mod:`repro_torch.core.spans`).
    """
    traced = spans.enabled()
    if traced:
        with spans.recording(spans.CHECK):
            _check_csr(u, v, n, arrays, block)
    else:
        _check_csr(u, v, n, arrays, block)
    dev = u.device
    if dev.type == "cpu":
        return census_csr_ref(u, v, n, arrays, block=block)
    if dev.type != "cuda":
        raise ValueError(f"census_csr runs on cuda or cpu, not {dev}")
    if traced:
        with spans.recording(spans.LAUNCH):
            return _launch_csr(u, v, n, arrays, k, block)
    return _launch_csr(u, v, n, arrays, k, block)


def _launch_csr(u, v, n: int, arrays, k: int, block: int) -> torch.Tensor:
    """:func:`census_csr`'s output and CUDA launch (inputs checked)."""
    dev = u.device
    D = u.shape[0]
    out = torch.empty((D // block, 16), dtype=torch.int32, device=dev)
    if D == 0:
        return out
    lib = _csr_lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.census_csr_launch(
            u.data_ptr(), v.data_ptr(), n, arrays.nbr_ptr.data_ptr(),
            arrays.nbr_idx.data_ptr(), arrays.nbr_flag.data_ptr(),
            arrays.nbr_cnt.data_ptr(), arrays.nbr_idx.shape[0],
            int(arrays.nbr_cnt.dim() == 2), D, block, int(k),
            out.data_ptr(), stream)
    if err:
        raise RuntimeError("census_csr launch failed: "
                           + lib.census_csr_error_string(err).decode())
    with _COUNT_LOCK:
        census_csr.launches += 1
    return out


census_csr.launches = 0
