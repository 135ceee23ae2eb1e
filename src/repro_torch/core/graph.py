"""CSR graph representation on a torch device.

Counterpart of :mod:`repro.core.graph`.  The graph lives as flat int32
tensors: the directed out-arc CSR (``out_ptr``/``out_idx``, used by
``IsEdge(u, v)``) and the open undirected neighbourhoods
(``nbr_ptr``/``nbr_idx``, used for the candidate set ``S`` and
``IsNeighbour``), both with sorted columns.

A :class:`CSRGraph` keeps the host numpy arrays it was built from
(``host``) beside the device tensors (``arrays``): host-side scheduling
(dyad enumeration for chunk bounds, bucket counts) reads the former and
never copies from the card.

Device rule: every constructor takes ``device``; ``None`` means
``"cuda"``, and asking for CUDA on a machine without it raises instead of
running on the CPU.

Out of core: :func:`from_edges_mmap` builds a graph whose arrays are
read-only ``np.memmap`` views of ``.npy`` files.  Such a graph holds no
tensors — ``arrays`` and ``host`` are the same memmaps, and ``device`` is
the CPU, where they live — so host code pages rows in on demand, and a
plan on any device copies what it needs: the padded whole graph
(:meth:`repro_torch.engine.Plan.padded_arrays`) or one shard's local CSR
at a time (:mod:`repro_torch.engine.partition`).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """The port's device rule: ``None`` means ``"cuda"``; a CUDA device on
    a machine without CUDA raises rather than falling back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev


def next_pow2(x: int) -> int:
    """Smallest power of two >= x (minimum 1) — the metadata bucket
    rounding rule of the plan keys."""
    return 1 << max(0, int(x) - 1).bit_length() if x > 1 else 1


class GraphArrays(NamedTuple):
    """Graph arrays (int32 unless noted): torch tensors on a device, or
    numpy arrays on the host.  ``in_ptr``/``in_idx`` hold the transpose
    (in-arc) CSR the tile gather needs; ``nbr_flag`` (int8) and ``nbr_cnt``
    the arc flags and range counts the CSR census kernel reads.  Only the
    plans and checks that use them build them
    (:mod:`repro_torch.kernels.ops`)."""

    out_ptr: "torch.Tensor | np.ndarray"  # (n+1,)
    out_idx: "torch.Tensor | np.ndarray"  # (m,) sorted within each row
    nbr_ptr: "torch.Tensor | np.ndarray"  # (n+1,)
    nbr_idx: "torch.Tensor | np.ndarray"  # (m_nbr,) sorted within each row
    nbr_deg: "torch.Tensor | np.ndarray"  # (n,) open-neighbourhood sizes
    in_ptr: "Optional[torch.Tensor | np.ndarray]" = None
    in_idx: "Optional[torch.Tensor | np.ndarray]" = None
    nbr_flag: "Optional[torch.Tensor | np.ndarray]" = None
    nbr_cnt: "Optional[torch.Tensor | np.ndarray]" = None


@dataclasses.dataclass(frozen=True, eq=False)
class CSRGraph:
    """Static metadata + device tensors + the host arrays they came from."""

    n: int
    m: int  # number of directed arcs
    m_nbr: int  # total undirected adjacency entries (2 * #undirected edges)
    max_deg: int  # max undirected open-neighbourhood size
    max_out_deg: int
    arrays: GraphArrays  # tensors on ``device`` (an mmap graph: memmaps)
    host: GraphArrays  # the same arrays as host numpy

    @property
    def n_dyads(self) -> int:
        """Number of canonical connected dyads (undirected edges)."""
        return self.m_nbr // 2

    @property
    def device(self) -> torch.device:
        """The device the graph's tensors live on; the CPU for a graph
        whose arrays are host memmaps (:func:`from_edges_mmap`)."""
        a = self.arrays.out_ptr
        return a.device if isinstance(a, torch.Tensor) else torch.device("cpu")


def _build_csr(n: int, rows: np.ndarray, cols: np.ndarray):
    """Sorted CSR from (row, col) pairs; rows/cols must be deduplicated."""
    order = np.lexsort((cols, rows))
    rows, cols = rows[order], cols[order]
    ptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(ptr, rows + 1, 1)
    ptr = np.cumsum(ptr)
    return ptr.astype(np.int32), cols.astype(np.int32)


def _build_host_arrays(n: int, src, dst, *, directed: bool = True):
    """Canonicalize the arc list and build both CSRs on the host.  Returns
    ``(host GraphArrays, m, m_nbr, max_deg, max_out_deg)``."""
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    if src.size:
        keep = src != dst
        src, dst = src[keep], dst[keep]
    if not directed and src.size:
        src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
    if src.size:  # dedup directed arcs
        key = src * np.int64(n) + dst
        _, uniq = np.unique(key, return_index=True)
        src, dst = src[uniq], dst[uniq]
    out_ptr, out_idx = _build_csr(n, src, dst)

    # undirected open neighbourhoods: union of arcs in both directions
    if src.size:
        usrc = np.concatenate([src, dst])
        udst = np.concatenate([dst, src])
        ukey = usrc * np.int64(n) + udst
        _, uniq = np.unique(ukey, return_index=True)
        usrc, udst = usrc[uniq], udst[uniq]
    else:
        usrc, udst = src, dst
    nbr_ptr, nbr_idx = _build_csr(n, usrc, udst)
    deg = (nbr_ptr[1:] - nbr_ptr[:-1]).astype(np.int32)
    out_deg = out_ptr[1:] - out_ptr[:-1]
    arrays = GraphArrays(out_ptr=out_ptr, out_idx=out_idx, nbr_ptr=nbr_ptr,
                         nbr_idx=nbr_idx, nbr_deg=deg)
    return (arrays, int(src.size), int(usrc.size),
            int(deg.max()) if n and deg.size else 0,
            int(out_deg.max()) if n and out_deg.size else 0)


def _graph_from_host(n: int, host: GraphArrays, m: int, m_nbr: int,
                     max_deg: int, max_out_deg: int, device) -> CSRGraph:
    dev = resolve_device(device)
    arrays = GraphArrays(*(torch.as_tensor(a).to(dev) for a in host[:5]))
    return CSRGraph(n=n, m=m, m_nbr=m_nbr, max_deg=max_deg,
                    max_out_deg=max_out_deg, arrays=arrays, host=host)


def from_edges(n: int, src, dst, *, directed: bool = True,
               device=None) -> CSRGraph:
    """Build a :class:`CSRGraph` from arc lists.

    Self-loops are dropped (the algorithm targets strict digraphs) and
    duplicate arcs are deduplicated, as in the paper's pre-processing
    stage.  For ``directed=False`` every edge is materialized as a mutual
    dyad.  The tensors land on ``device`` (``None`` = ``"cuda"``).
    """
    host, m, m_nbr, max_deg, max_out_deg = _build_host_arrays(
        n, src, dst, directed=directed)
    return _graph_from_host(n, host, m, m_nbr, max_deg, max_out_deg, device)


def graph_from_reference_arrays(n: int, arrays, *, device=None) -> CSRGraph:
    """Build the port's graph from another package's five CSR arrays.

    ``arrays`` is any record with ``out_ptr``, ``out_idx``, ``nbr_ptr``,
    ``nbr_idx`` and ``nbr_deg`` attributes convertible to numpy (the JAX
    package's ``GraphArrays`` pulled to the host, or this package's own
    ``CSRGraph.host``).  The arrays are copied as they are, so both
    packages then run on identical CSRs; the counts and maxima are derived
    from them.
    """
    host = GraphArrays(*(np.array(getattr(arrays, f), dtype=np.int32)
                         for f in GraphArrays._fields[:5]))
    out_deg = np.diff(host.out_ptr)
    return _graph_from_host(
        n, host, m=int(host.out_ptr[-1]), m_nbr=int(host.nbr_ptr[-1]),
        max_deg=int(host.nbr_deg.max()) if host.nbr_deg.size else 0,
        max_out_deg=int(out_deg.max()) if out_deg.size else 0,
        device=device)


def from_edges_mmap(n: int, src, dst, *, directed: bool = True,
                    dir: "str | None" = None) -> CSRGraph:
    """Build a :class:`CSRGraph` whose arrays are **memory-mapped** host
    ``.npy`` files — the out-of-core constructor.

    Canonicalization is :func:`from_edges`'s (the same helper, so both
    give the same arrays for the same arcs); the five CSR arrays are then
    written to ``dir`` (a fresh temporary directory when ``None``) and
    reopened read-only with ``mmap_mode="r"``.  The graph holds no
    tensors: ``arrays`` and ``host`` are those memmaps and ``device`` is
    the CPU (see the module docstring).  The files are the caller's: they
    stay in ``dir`` after the graph is dropped.
    """
    import os
    import tempfile

    host, m, m_nbr, max_deg, max_out_deg = _build_host_arrays(
        n, src, dst, directed=directed)
    d = dir if dir is not None else tempfile.mkdtemp(prefix="repro-graph-")
    os.makedirs(d, exist_ok=True)

    def spill(name: str, arr: np.ndarray) -> np.ndarray:
        if arr.size == 0:  # np.memmap rejects zero-length buffers
            return arr
        path = os.path.join(d, f"{name}.npy")
        mm = np.lib.format.open_memmap(path, mode="w+", dtype=arr.dtype,
                                       shape=arr.shape)
        mm[:] = arr
        mm.flush()
        del mm
        return np.load(path, mmap_mode="r")

    arrays = GraphArrays(*(spill(f, a) for f, a in
                           zip(GraphArrays._fields[:5], host[:5])))
    return CSRGraph(n=n, m=m, m_nbr=m_nbr, max_deg=max_deg,
                    max_out_deg=max_out_deg, arrays=arrays, host=arrays)


def tensor_arrays(arrays: GraphArrays, device) -> GraphArrays:
    """Five CSR arrays as tensors on ``device``: tensors are moved (no copy
    on their own device), host arrays — a shard's local CSR, an mmap
    graph's memmaps — are read into memory once and copied there."""
    def one(a):
        if isinstance(a, torch.Tensor):
            return a.to(device)
        a = np.asarray(a, dtype=np.int32)
        return torch.from_numpy(a if a.flags.writeable else a.copy()).to(
            device)

    return GraphArrays(*(one(a) for a in arrays[:5]))


def arcs_host(g: CSRGraph) -> "tuple[np.ndarray, np.ndarray]":
    """The directed arc list ``(src, dst)`` as host int64 arrays — the
    exact inverse of :func:`from_edges` for deduplicated strict digraphs."""
    out_ptr = g.host.out_ptr[: g.n + 1]
    dst = g.host.out_idx[: g.m].astype(np.int64)
    src = np.repeat(np.arange(g.n, dtype=np.int64), np.diff(out_ptr))
    return src, dst


def arcs_host_iter(g: CSRGraph, *, cuts=None, block: int = 1 << 16):
    """Stream the directed arc list one contiguous vertex range at a time:
    yields an int64 ``(src, dst)`` pair per range, reading only that
    range's rows (O(range) host memory on an mmap graph, where
    :func:`arcs_host` reads the whole list).  Ranges come from ``cuts``
    (e.g. :func:`repro_torch.core.partition.partition_cuts`, to walk the
    engine's shards) or ``block``-sized strides.  The concatenation of
    every yield is :func:`arcs_host`."""
    ptr = np.asarray(g.host.out_ptr)[: g.n + 1].astype(np.int64)
    idx = g.host.out_idx
    bounds = (np.asarray(cuts, dtype=np.int64) if cuts is not None
              else np.arange(0, g.n + block, block,
                             dtype=np.int64).clip(max=g.n))
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        lo, hi = int(lo), int(hi)
        if hi <= lo:
            continue
        dst = np.asarray(idx[ptr[lo]:ptr[hi]], dtype=np.int64)
        src = np.repeat(np.arange(lo, hi, dtype=np.int64),
                        np.diff(ptr[lo:hi + 1]))
        yield src, dst


def dense_adjacency(g: CSRGraph) -> np.ndarray:
    """(n, n) boolean adjacency — for small-graph oracles only."""
    a = np.zeros((g.n, g.n), dtype=bool)
    ptr, idx = g.host.out_ptr, g.host.out_idx
    for u in range(g.n):
        a[u, idx[ptr[u]: ptr[u + 1]]] = True
    return a


def load_pajek_or_edgelist(path: str, *, device=None) -> CSRGraph:
    """Minimal loader for Pajek ``*Vertices/*Arcs/*Edges`` or ``u v`` lines.

    Pajek files are 1-indexed, plain edge lists 0-indexed (paper §5.1.1);
    vertex-label lines after ``*Vertices`` are skipped.
    """
    srcs: list[int] = []
    dsts: list[int] = []
    undirected_rows: list[int] = []
    n = 0
    mode = "edges"
    pajek = False
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith(("#", "%")):
                continue
            low = line.lower()
            if low.startswith("*vertices"):
                n = int(line.split()[1])
                pajek = True
                mode = "vertices"
                continue
            if low.startswith("*arcs"):
                mode = "arcs"
                continue
            if low.startswith("*edges"):
                mode = "undirected"
                continue
            if line.startswith("*"):
                mode = "skip"
                continue
            if mode in ("skip", "vertices"):
                continue
            parts = line.split()
            if len(parts) < 2:
                continue
            u, v = int(parts[0]), int(parts[1])
            if pajek:
                u, v = u - 1, v - 1
            srcs.append(u)
            dsts.append(v)
            if mode == "undirected":
                undirected_rows.append(len(srcs) - 1)
    src = np.array(srcs, dtype=np.int64)
    dst = np.array(dsts, dtype=np.int64)
    if undirected_rows:
        extra = np.array(undirected_rows)
        src = np.concatenate([src, dst[extra]])
        dst = np.concatenate([dst, np.array(srcs, dtype=np.int64)[extra]])
    if not n:
        n = int(max(src.max(initial=-1), dst.max(initial=-1)) + 1)
    return from_edges(n, src, dst, directed=True, device=device)
