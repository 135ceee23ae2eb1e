"""Front doors of the port's kernels, counterpart of :mod:`repro.kernels.ops`.

* ``flash_attention(q, k, v, q_pos, kv_pos, *, window=None)`` — the flash
  kernel (:mod:`repro_torch.kernels.flash_attention`; ``repro``'s
  ``ops.flash_attention`` without its ``chunk`` and ``interpret``: the
  CUDA kernel has its own tile, and a CPU tensor runs the plain version).
* Tile construction for the census tile kernel: the transpose CSR and the
  six SENTINEL-padded neighbourhood tiles of a dyad chunk, as torch ops
  (device) and numpy (host).  Every tile row comes out sorted ascending
  with a SENTINEL tail and no duplicates: CSR columns are sorted and the
  transpose is built by a stable sort.  The CUDA kernel relies on that to
  find a row's length and probe it by binary search.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.graph import CSRGraph, GraphArrays
from .flash_attention import flash_attention  # noqa: F401
from .triad_census import SENTINEL

TILE_NAMES = ("out_u", "in_u", "out_v", "in_v", "nbr_u", "nbr_v")


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
