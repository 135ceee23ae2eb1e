"""Shared pieces of the port's sharded-path tests: ``gloo`` ranks on the
CPU spawned once per world size (a ``file://`` store, each rank's results
pickled for the test process to read), the meshes, and the comparison
standard of the one-card training tests (``tests/test_torch_train_step.py``
and ``tests/test_torch_optimizer.py``)."""
import datetime
import os
import pickle

import numpy as np

TIMEOUT_S = 120
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


def spawn(fn, world, tmp, inputs) -> list:
    """Run ``fn(rank, world, init_file, tmp)`` on ``world`` ranks after
    pickling ``inputs`` to ``tmp/inputs.pkl``; returns each rank's
    pickled ``tmp/rank{r}.pkl``."""
    import torch.multiprocessing as mp

    os.makedirs(tmp, exist_ok=True)
    with open(os.path.join(tmp, "inputs.pkl"), "wb") as f:
        pickle.dump(inputs, f)
    # every rank hashes strings alike: DTensor's strategy choice depends
    # on it (``repro_torch.launch.mesh.check_same_hash_seed``)
    seed = os.environ.get("PYTHONHASHSEED")
    os.environ["PYTHONHASHSEED"] = "0"
    try:
        mp.spawn(fn, args=(world, os.path.join(tmp, "pg"), tmp),
                 nprocs=world, join=True)
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
