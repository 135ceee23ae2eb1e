"""Front doors of the port's kernels, counterpart of :mod:`repro.kernels.ops`.

* ``flash_attention(q, k, v, q_pos, kv_pos, *, window=None, chunk=1024)``
  — the flash kernel (:mod:`repro_torch.kernels.flash_attention`;
  ``repro``'s ``ops.flash_attention`` without its ``interpret``: a CPU
  tensor runs the plain version.  The CUDA kernel has its own tile;
  ``chunk`` is the block of the backward's recompute under autograd).
* The arc flags and range counts the CSR census kernel reads
  (:func:`build_arc_flags_device`, host twin :func:`build_arc_flags`).
* Tile construction for the census tile kernel: the transpose CSR and the
  six SENTINEL-padded neighbourhood tiles of a dyad chunk, as torch ops
  (device) and numpy (host).  Every tile row comes out sorted ascending
  with a SENTINEL tail and no duplicates: CSR columns are sorted and the
  transpose is built by a stable sort.  The CUDA kernel relies on that to
  find a row's length and probe it by binary search.  The main path no
  longer builds tiles: they are the six-tile kernel's interface, kept as
  the counterpart of the Pallas kernel's.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.graph import CSRGraph, GraphArrays
from .flash_attention import flash_attention  # noqa: F401
from .triad_census import SENTINEL

TILE_NAMES = ("out_u", "in_u", "out_v", "in_v", "nbr_u", "nbr_v")
#: the packed range counts hold two 16-bit fields: degrees up to this
MAX_PACKED_DEGREE = 2**16 - 1


def build_arc_flags(out_ptr, out_idx, nbr_ptr, nbr_idx, *, wide=False):
    """Host twin of :func:`build_arc_flags_device` on padded numpy arrays."""
    n = len(nbr_ptr) - 1
    M = len(nbr_idx)
    pos = np.arange(M)
    live = pos < nbr_ptr[-1]
    rows = np.searchsorted(nbr_ptr, pos, side="right") - 1
    w = np.asarray(nbr_idx, np.int64)
    out_rows = np.repeat(np.arange(n, dtype=np.int64),
                         np.diff(out_ptr)[:n])
    arcs = set(zip(out_rows.tolist(),
                   np.asarray(out_idx[: out_ptr[-1]], np.int64).tolist()))
    flags = np.zeros(M, np.int8)
    counts = np.zeros((2, M), np.int64)
    for p in np.flatnonzero(live):
        x, y = int(rows[p]), int(w[p])
        flags[p] = ((x, y) in arcs) + 2 * ((y, x) in arcs)
    for x in range(n):
        run = np.zeros(2, np.int64)
        for p in range(nbr_ptr[x], nbr_ptr[x + 1]):
            if flags[p] in (1, 2):
                run[flags[p] - 1] += 1
            counts[:, p] = run
    if wide:
        return flags, counts.astype(np.int32)
    return flags, _to_int32_bits(counts[0] + (counts[1] << 16))


def _to_int32_bits(x):
    """int64 values in [0, 2**32) to int32 holding the same 32 bits."""
    if isinstance(x, np.ndarray):
        return np.where(x >= 2**31, x - 2**32, x).astype(np.int32)
    return torch.where(x >= 2**31, x - 2**32, x).int()


def build_arc_flags_device(out_ptr: torch.Tensor, out_idx: torch.Tensor,
                           nbr_ptr: torch.Tensor, nbr_idx: torch.Tensor, *,
                           wide: bool = False):
    """Direction flags and per-row range counts of the undirected CSR.

    For the arc at position ``p`` of row ``x`` of ``nbr`` (``w =
    nbr_idx[p]``), ``flags[p] = [x -> w] + 2 [w -> x]`` (int8, 1..3 for a
    real arc).  The range counts say how many of the row's positions up to
    and including ``p`` have flag 1 and flag 2, so the counts over
    positions ``(a, b]`` of one row are the difference of two reads.
    Packed (the default), ``counts[p]`` holds them in its low and high 16
    bits and the difference is taken in 32-bit unsigned arithmetic: every
    degree must stay at or below :data:`MAX_PACKED_DEGREE`.  ``wide``
    gives them as two int32 rows, ``counts[0, p]`` and ``counts[1, p]``,
    for any degree.

    Inputs are the bucket-padded CSRs (padded ptr rows repeat the last
    offset); padding arcs get flag 0 and count 0.  Each flag comes from
    two ``searchsorted`` of 64-bit keys ``x * n + w`` into the sorted
    out-arc keys.
    """
    dev = nbr_idx.device
    n = nbr_ptr.shape[0] - 1
    M = nbr_idx.shape[0]
    big = torch.iinfo(torch.int64).max

    def row_of(ptr, length):
        pos = torch.arange(length, dtype=torch.int32, device=dev)
        rows = torch.searchsorted(ptr, pos, right=True).long() - 1
        return rows, pos < ptr[-1]

    o_rows, o_live = row_of(out_ptr, out_idx.shape[0])
    out_keys = torch.where(o_live, o_rows * n + out_idx.long(), big)
    rows, live = row_of(nbr_ptr, M)
    w = nbr_idx.long()

    def is_arc(src, dst):
        key = torch.where(live, src * n + dst, big - 1)
        at = torch.searchsorted(out_keys, key).clamp_(max=out_keys.shape[0] - 1)
        return live & (out_keys[at] == key)

    flags = (is_arc(rows, w).to(torch.int8)
             + 2 * is_arc(w, rows).to(torch.int8))
    # one 1-D scan of both counts, flag 1 in the low and flag 2 in the
    # high 32 bits: a scan along dim 1 of a (2, M) tensor took 1.67 ms at
    # Slashdot size on an H100 (PERF.md); in place after the scan, so the
    # run's peak memory holds no more M-long int64 temporaries than it must
    ones = (flags == 1).long() + ((flags == 2).long() << 32)
    counts = torch.cumsum(ones, 0)
    before = (counts - ones)[
        nbr_ptr[rows.clamp(max=n - 1)].long().clamp(max=M - 1)]
    del ones
    counts.sub_(before).masked_fill_(~live, 0)
    del before
    high = counts >> 32
    counts.bitwise_and_(0xFFFFFFFF)
    if wide:
        return flags, torch.stack([counts, high]).int()
    return flags, _to_int32_bits(counts.add_(high.bitwise_left_shift_(16)))


def _pad_rows(ptr, idx, rows, K):
    """(len(rows), K) tile of CSR rows padded with SENTINEL (host numpy)."""
    deg = ptr[rows + 1] - ptr[rows]
    out = np.full((len(rows), K), SENTINEL, dtype=np.int32)
    j = np.arange(K)
    m = j[None, :] < deg[:, None]
    pos = np.minimum(ptr[rows][:, None] + j[None, :], len(idx) - 1)
    vals = idx[pos]
    out[m] = vals[m]
    return out


def build_in_csr(g: CSRGraph) -> "tuple[np.ndarray, np.ndarray]":
    """Transpose CSR on the host, for the ``IsEdge(w, u) -> w in IN(u)``
    reformulation the tiles use."""
    out_ptr, out_idx = g.host.out_ptr, g.host.out_idx
    rows = np.repeat(np.arange(g.n, dtype=np.int64), np.diff(out_ptr))
    # primary key = in-row (out_idx), secondary = in-col (rows)
    order = np.lexsort((rows, out_idx))
    in_rows, in_cols = out_idx[order].astype(np.int64), rows[order]
    in_ptr = np.zeros(g.n + 1, np.int64)
    np.add.at(in_ptr, in_rows + 1, 1)
    in_ptr = np.cumsum(in_ptr)
    return in_ptr, in_cols.astype(np.int32)


def build_in_csr_device(out_ptr: torch.Tensor, out_idx: torch.Tensor):
    """Device-side :func:`build_in_csr` from the bucket-padded directed CSR.

    The true arc count is ``out_ptr[-1]`` (padded ptr rows repeat the last
    offset); padding entries get sort key ``n`` so they land past every
    real row.  Returns ``(in_ptr, in_idx)`` int32 with the padded shapes.
    """
    dev = out_idx.device
    M = out_idx.shape[0]
    n = out_ptr.shape[0] - 1
    pos = torch.arange(M, dtype=torch.int32, device=dev)
    rows = torch.searchsorted(out_ptr, pos, right=True) - 1
    cols_key = torch.where(pos < out_ptr[-1], out_idx, n).long()
    order = torch.argsort(cols_key, stable=True)  # rows stay sorted
    in_idx = rows[order].int()
    counts = torch.zeros(n + 1, dtype=torch.int32, device=dev)
    counts.index_add_(0, cols_key, torch.ones(M, dtype=torch.int32,
                                              device=dev))
    in_ptr = torch.cat([torch.zeros(1, dtype=torch.int32, device=dev),
                        torch.cumsum(counts[:n], 0, dtype=torch.int32)])
    return in_ptr, in_idx


def _gather_rows(ptr, idx, rows, row_valid, K: int):
    """(B, K) SENTINEL-padded tile of CSR rows — the device ``_pad_rows``."""
    r = torch.where(row_valid, rows, 0).long()
    start = ptr[r].long()
    deg = ptr[r + 1].long() - start
    j = torch.arange(K, device=rows.device)
    pos = (start[:, None] + j[None, :]).clamp_(0, idx.shape[0] - 1)
    live = row_valid[:, None] & (j[None, :] < deg[:, None])
    return torch.where(live, idx[pos], SENTINEL)


def gather_tiles_device(arrays: GraphArrays, u: torch.Tensor,
                        v: torch.Tensor, valid: torch.Tensor, *,
                        K: int) -> dict:
    """Device-side :func:`build_tiles`: all six (B, K) int32 tiles.

    ``arrays`` must carry the transpose CSR (:func:`build_in_csr_device`).
    Rows with ``valid == False`` come back all-SENTINEL.
    """
    rows = dict(out=(arrays.out_ptr, arrays.out_idx),
                in_=(arrays.in_ptr, arrays.in_idx),
                nbr=(arrays.nbr_ptr, arrays.nbr_idx))
    return dict(
        out_u=_gather_rows(*rows["out"], u, valid, K),
        in_u=_gather_rows(*rows["in_"], u, valid, K),
        out_v=_gather_rows(*rows["out"], v, valid, K),
        in_v=_gather_rows(*rows["in_"], v, valid, K),
        nbr_u=_gather_rows(*rows["nbr"], u, valid, K),
        nbr_v=_gather_rows(*rows["nbr"], v, valid, K),
    )


def build_tiles(g: CSRGraph, u: np.ndarray, v: np.ndarray, K: int,
                in_csr: "tuple[np.ndarray, np.ndarray] | None" = None) -> dict:
    """All six (D, K) neighbourhood tiles for a dyad batch (host numpy)."""
    h = g.host
    in_ptr, in_idx = in_csr if in_csr is not None else build_in_csr(g)
    return dict(
        out_u=_pad_rows(h.out_ptr, h.out_idx, u, K),
        in_u=_pad_rows(in_ptr, in_idx, u, K),
        out_v=_pad_rows(h.out_ptr, h.out_idx, v, K),
        in_v=_pad_rows(in_ptr, in_idx, v, K),
        nbr_u=_pad_rows(h.nbr_ptr, h.nbr_idx, u, K),
        nbr_v=_pad_rows(h.nbr_ptr, h.nbr_idx, v, K),
    )
