"""Fault-tolerant checkpointing: atomic, async, auto-resume.

Counterpart of :mod:`repro.train.checkpoint`, in the same on-disk format,
so a checkpoint written by either package restores in the other:

* ``<dir>/step_<10 digits>/<tree>/<key>.npy``, one file per key of each
  tree (``/`` in a key written as ``__``), and ``MANIFEST.json`` (step,
  index of keys per tree, meta, time) written last;
* **atomic**: written to ``<dir>/tmp.<step>`` and renamed, so a crash
  mid-save never corrupts the latest checkpoint, and a directory without
  a manifest is not a checkpoint;
* **async**: the device-to-host copy happens in ``save``; the disk writes
  run on a thread while training goes on;
* ``keep`` newest checkpoints are kept; ``latest_step`` finds the newest
  complete one;
* data-pipeline state is the step alone (the pipeline is deterministic);
* **written once** in a process group: every rank hands ``save`` the
  whole trees (a sharded model's are gathered by :func:`train_state`, a
  collective), rank 0 alone writes them, and :meth:`CheckpointManager.wait`
  (which every rank calls, at the end of a run or before another rank
  reads the directory) ends in a barrier: after it the write is on disk
  for all.  :meth:`~CheckpointManager.latest_step` is a plain read of the
  directory, as JAX's, and any one rank may call it alone.

Trees are flat dicts of tensors or arrays; a train loop saves the JAX
keys and layouts (:func:`train_state`), as the JAX package does, and
takes them back with :func:`restore_train_state`.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time

import numpy as np
import torch
import torch.distributed as dist

from ..core.graph import resolve_device
from ..models.convert import from_jax_tree, to_jax_params
from ..sharding.rules import from_whole, mesh_placements
from .optimizer import OptState

MANIFEST = "MANIFEST.json"


def _safe(path: str) -> str:
    return path.replace("/", "__")


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, async_save: bool = True):
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: threading.Thread | None = None
        self._group = dist.is_available() and dist.is_initialized()
        self.writer = not self._group or dist.get_rank() == 0
        os.makedirs(directory, exist_ok=True)

    # -- save ---------------------------------------------------------------
    def save(self, step: int, trees: dict, meta: dict | None = None):
        """trees: ``{"params": flat dict, "m": ..., ...}`` of tensors or
        arrays, copied to the host before this returns.  In a process
        group every rank calls it with the same whole trees; rank 0
        writes."""
        self.wait()
        if not self.writer:
            return
        host = {tname: {k: _host(v) for k, v in tree.items()}
                for tname, tree in trees.items()}
        if self.async_save:
            self._thread = threading.Thread(
                target=self._write, args=(step, host, meta or {}), daemon=True)
            self._thread.start()
        else:
            self._write(step, host, meta or {})

    def _write(self, step: int, host: dict, meta: dict):
        tmp = os.path.join(self.dir, f"tmp.{step}")
        final = os.path.join(self.dir, f"step_{step:010d}")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        index = {}
        for tname, tree in host.items():
            sub = os.path.join(tmp, tname)
            os.makedirs(sub)
            for k, arr in tree.items():
                np.save(os.path.join(sub, _safe(k) + ".npy"), arr)
            index[tname] = sorted(tree)
        with open(os.path.join(tmp, MANIFEST), "w") as f:
            json.dump({"step": step, "index": index, "meta": meta,
                       "time": time.time()}, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()

    def wait(self):
        """Join the pending async write, if any; in a process group, then
        a barrier (every rank calls it as often: after it the write is on
        disk for all)."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._group:
            dist.barrier()

    def _gc(self):
        for s in self.all_steps()[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:010d}"),
                          ignore_errors=True)

    # -- restore ------------------------------------------------------------
    def all_steps(self) -> list[int]:
        """Steps of the complete checkpoints (those with a manifest)."""
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and os.path.exists(
                    os.path.join(self.dir, name, MANIFEST)):
                out.append(int(name[5:]))
        return sorted(out)

    def latest_step(self) -> int | None:
        """The newest complete checkpoint's step, or None: what is on disk
        now (a pending write of this manager's is not waited for; call
        :meth:`wait` first, on every rank, to see it)."""
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, device=None, *, mesh=None, specs=None):
        """``(trees, meta)``: every tree of checkpoint ``step`` as a dict of
        tensors on ``device`` (``None`` means ``"cuda"``), or, with
        ``mesh`` and ``specs`` (``{tree name: {key: spec}}``, as
        :func:`~repro_torch.models.params.param_specs` gives for the JAX
        keys), as DTensors placed on ``mesh`` by those specs; a tree
        without specs is whole on the mesh's device.  Placed leaves are
        read one at a time from a memory map of their file, each rank
        reading and moving only its own block: no rank ever holds a whole
        sharded leaf, and no collective runs."""
        d = os.path.join(self.dir, f"step_{step:010d}")
        with open(os.path.join(d, MANIFEST)) as f:
            manifest = json.load(f)
        specs = specs or {}
        dev = mesh.device_type if mesh is not None else resolve_device(
            device)
        out = {}
        for tname, keys in manifest["index"].items():
            out[tname] = {}
            for k in keys:
                arr = np.load(os.path.join(d, tname, _safe(k) + ".npy"),
                              mmap_mode="r")
                if mesh is not None and tname in specs:
                    out[tname][k] = from_whole(arr, mesh, mesh_placements(
                        mesh, tuple(specs[tname][k])))
                else:
                    out[tname][k] = torch.from_numpy(np.array(arr)).to(dev)
        return out, manifest["meta"]


def train_state(model, opt: OptState, device="cpu", *,
                keep: bool = True) -> dict:
    """The trees a train loop checkpoints, as the JAX package's launcher
    saves them: ``{"params", "m", "v"}`` in the JAX keys and layouts
    (:func:`repro_torch.models.convert.to_jax_params`), on ``device``
    (the host by default, so the restacked copy never sits on the
    card).  A sharded model's trees are gathered whole, one parameter at
    a time: a collective every rank calls; a rank that does not write
    passes ``keep=False`` (:attr:`CheckpointManager.writer`) and holds
    none of it."""
    return {"params": to_jax_params(model, device=device, keep=keep),
            "m": to_jax_params(model, opt.m, device=device, keep=keep),
            "v": to_jax_params(model, opt.v, device=device, keep=keep)}


def restore_train_state(model, trees: dict, step: int) -> OptState:
    """Copy ``trees["params"]`` (JAX keys, from either package) into the
    model's parameters in place and return the optimizer state at
    ``step`` from ``trees["m"]`` and ``trees["v"]``.  On a sharded model
    each value is placed as its parameter, whatever mesh wrote the
    checkpoint (an elastic resume); trees placed on the model's mesh
    (:meth:`CheckpointManager.restore` with ``mesh``) give each rank its
    blocks without a collective (:func:`~repro_torch.models.convert.
    from_jax_tree`)."""
    params = dict(model.named_parameters())
    with torch.no_grad():
        for name, val in from_jax_tree(model, trees["params"]).items():
            params[name].copy_(val)
    return OptState(step=step, m=from_jax_tree(model, trees["m"]),
                    v=from_jax_tree(model, trees["v"]))
