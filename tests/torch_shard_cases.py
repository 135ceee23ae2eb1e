"""Shared pieces of the port's sharded-path tests: ``gloo`` ranks on the
CPU spawned once per world size (a ``file://`` store, each rank's results
pickled for the test process to read), the meshes, and the comparison
standard of the one-card training tests (``tests/test_torch_train_step.py``
and ``tests/test_torch_optimizer.py``)."""
import datetime
import os
import pickle
import time

import numpy as np

TIMEOUT_S = 120  # the process group's bound on one collective
SPAWN_TIMEOUT_S = 600  # the bound on a whole spawn
#: label -> ((data, model) mesh shape, RunConfig overrides)
MESHES = {"m12": ((1, 2), {}), "m21": ((2, 1), {}),
          "m12_asm": ((1, 2), {"act_shard_model": True}),
          "m21_asm": ((2, 1), {"act_shard_model": True})}


def init_group(rank, world, init_file):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)  # the ranks share the test worker's cores
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))


def mesh_of(shape):
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))


def spawn(fn, world, tmp, inputs, timeout=SPAWN_TIMEOUT_S) -> list:
    """Run ``fn(rank, world, init_file, tmp)`` on ``world`` ranks after
    pickling ``inputs`` to ``tmp/inputs.pkl``; returns each rank's
    pickled ``tmp/rank{r}.pkl``.  A collective that waits past
    ``TIMEOUT_S`` raises in its rank (the group's timeout), and ranks
    still running after ``timeout`` seconds are terminated and the spawn
    raises, so a deadlock fails the test instead of hanging it."""
    import torch.multiprocessing as mp

    os.makedirs(tmp, exist_ok=True)
    with open(os.path.join(tmp, "inputs.pkl"), "wb") as f:
        pickle.dump(inputs, f)
    # every rank hashes strings alike: DTensor's strategy choice depends
    # on it (``repro_torch.launch.mesh.check_same_hash_seed``)
    seed = os.environ.get("PYTHONHASHSEED")
    os.environ["PYTHONHASHSEED"] = "0"
    try:
        ctx = mp.spawn(fn, args=(world, os.path.join(tmp, "pg"), tmp),
                       nprocs=world, join=False)
        deadline = time.monotonic() + timeout
        while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                for p in ctx.processes:
                    p.kill()
                raise TimeoutError(f"{world} ranks still ran after "
                                   f"{timeout} s")
    finally:
        if seed is None:
            del os.environ["PYTHONHASHSEED"]
        else:
            os.environ["PYTHONHASHSEED"] = seed
    out = []
    for r in range(world):
        with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def load_inputs(tmp):
    with open(os.path.join(tmp, "inputs.pkl"), "rb") as f:
        return pickle.load(f)


def save_result(tmp, rank, out):
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def spec_slice(a, spec, sizes: dict, coord: dict):
    """The block of the whole array ``a`` that a JAX ``spec`` gives the
    rank at mesh coordinate ``coord`` (``{axis: index}``) of a mesh of
    ``sizes``: each dim split over its axes, the first outermost, in
    chunks of ``ceil(n / shards)``, as GSPMD and a DTensor ``Shard``
    split it."""
    for dim, entry in enumerate(spec):
        axes = (entry,) if isinstance(entry, str) else entry or ()
        n_split, pos = 1, 0
        for ax in axes:
            n_split, pos = n_split * sizes[ax], pos * sizes[ax] + coord[ax]
        size = -(-a.shape[dim] // n_split)
        a = np.take(a, np.arange(pos * size, min(a.shape[dim],
                                                 (pos + 1) * size)), axis=dim)
    return a


def scaled(got, want) -> float:
    """max |got - want| over want's largest magnitude."""
    return float(np.abs(np.asarray(got) - np.asarray(want)).max()) / max(
        float(np.abs(np.asarray(want)).max()), 1e-30)


def assert_step_matches(got: dict, want: dict, lr: float, tag=""):
    """A step's parameters against another's from the same state: within
    1e-5, except that at most 1e-4 of the elements may move by up to 2 *
    lr (Adam divides a near-zero gradient element by its own magnitude,
    so f32 summation order may flip its sign)."""
    off, total = 0, 0
    for k, w in want.items():
        diff = np.abs(np.asarray(got[k]) - np.asarray(w))
        assert float(diff.max()) <= 2 * lr, (tag, k, float(diff.max()))
        off += int((diff > 1e-5).sum())
        total += diff.size
    assert off <= 1e-4 * total, (tag, off, total)
