"""Training launcher: sharded parameters, checkpointing, auto-resume,
straggler watchdog.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-4b \\
        --steps 100 [--smoke] [--device cpu] [--model-parallel N]
    PYTHONHASHSEED=0 PYTHONPATH=src torchrun --nproc-per-node 2 \\
        -m repro_torch.launch.train --smoke --device cpu --model-parallel 2

Counterpart of :mod:`repro.launch.train`: the model is built from seed 0
(f32 parameters, bf16 compute, ``remat="full"``, the flash kernel with
chunk ``min(1024, seq)``), batches come from
:class:`~repro_torch.data.SyntheticTokens`, and a run resumes from the
newest complete checkpoint in ``--ckpt-dir``.  ``--device`` defaults to
``cuda`` and raises without a card; ``--smoke`` (the reduced config) on
``--device cpu`` is the path that runs without one.

In a process group (``torchrun`` sets one up: ``nccl`` on ``cuda``,
``gloo`` on ``cpu``; or the caller's own) the run is sharded, as JAX's:
a ``(data, model)`` mesh of ``plan_elastic_mesh(world, N)`` for
``--model-parallel N`` > 1 (the TP degree, kept across elastic
restarts; the data axis takes the rest), else ``(world, 1)``; the rules
``make_rules(mesh, vocab_shardable=vocab % model == 0)`` with the run's
``fsdp_axis`` and ``act_shard_model``; every parameter and moment a
DTensor placed by them, every batch split on the batch axes.  Every rank
must hash strings alike (the same ``PYTHONHASHSEED``; the mesh checks
it: :mod:`repro_torch.launch.mesh`).  The
checkpoint holds whole tensors, so a run resumes onto any mesh shape.
"""
from __future__ import annotations

import argparse
import os
import tempfile

import torch
import torch.distributed as dist

from ..config import RunConfig, get_config
from ..core.graph import resolve_device
from ..data import SyntheticTokens
from ..models.convert import init_module
from ..models.params import param_specs
from ..models.transformer import model_defs
from ..sharding.rules import make_rules
from ..train import (CheckpointManager, adamw_init, make_train_step,
                     restore_train_state, train_state)
from ..train.elastic import StepWatchdog, plan_elastic_mesh
from .mesh import make_mesh_for


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--model-parallel", type=int, default=0,
                    help="TP degree (0 = all ranks on one data axis)")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def init_world(device: torch.device) -> int:
    """The process group's size: the caller's group, or one ``torchrun``
    describes (``WORLD_SIZE`` > 1 in the environment; ``nccl`` on a card,
    ``gloo`` on the CPU), else 1 (no group)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        if device.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo")
        return dist.get_world_size()
    return 1


def make_mesh(world: int, model_parallel: int, device: torch.device):
    """The run's ``(data, model)`` mesh over the process group (JAX's
    launcher's), or None without a group."""
    if not (dist.is_available() and dist.is_initialized()):
        if model_parallel > 1:
            raise ValueError(f"--model-parallel {model_parallel} needs a "
                             "process group (torchrun)")
        return None
    if model_parallel > 1:
        plan_elastic_mesh(world, model_parallel)  # raises below the TP degree
    return make_mesh_for(world, max(model_parallel, 1), device.type)


def train_setup(cfg, run: RunConfig, device, *, model_parallel: int = 0,
                microbatch=None, total_steps: int = 50):
    """``(model, opt, step_fn, mesh, rules)``: the model from seed 0 with
    its parameters placed on the run's mesh (:func:`make_mesh`, None
    without a process group), zero moments, and the train step for that
    mesh.  Each rank draws the model a layer's slice at a time and keeps
    only its own blocks (:func:`~repro_torch.models.convert.init_module`)."""
    dev = resolve_device(device)
    mesh = make_mesh(init_world(dev), model_parallel, dev)
    rules = None
    if mesh is not None:
        rules = make_rules(mesh, fsdp_axis=run.fsdp_axis,
                           act_shard_model=run.act_shard_model,
                           vocab_shardable=cfg.vocab_size
                           % mesh["model"].size() == 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    model = init_module(cfg, gen, run=run, trainable=True, mesh=mesh,
                        rules=rules)
    opt = adamw_init(dict(model.named_parameters()))
    step_fn = make_train_step(cfg, run, mesh, rules, microbatch=microbatch,
                              total_steps=total_steps,
                              warmup=max(2, total_steps // 10))
    return model, opt, step_fn, mesh, rules


def main(argv=None):
    args = parse_args(argv)
    dev = resolve_device(args.device)
    own_group = not (dist.is_available() and dist.is_initialized())
    cfg = get_config(args.arch, smoke=args.smoke)
    run = RunConfig(attention_chunk=min(1024, args.seq))
    model, opt, step_fn, mesh, rules = train_setup(
        cfg, run, dev, model_parallel=args.model_parallel,
        microbatch=args.microbatch or None, total_steps=args.steps)
    shape = None if mesh is None else dict(zip(mesh.mesh_dim_names,
                                               mesh.shape))
    print(f"device={dev} mesh={shape} params={cfg.param_count() / 1e6:.1f}M",
          flush=True)

    mgr = CheckpointManager(args.ckpt_dir, keep=2)
    start = mgr.latest_step()
    if start is not None:
        if mesh is None:
            trees = mgr.restore(start, device=dev)[0]
        else:  # each rank reads its own blocks
            specs = param_specs(model_defs(cfg), rules)
            trees = mgr.restore(start, mesh=mesh, specs=dict.fromkeys(
                ("params", "m", "v"), specs))[0]
        opt = restore_train_state(model, trees, start)
        del trees
        print(f"resume from step {start} onto {shape}", flush=True)
    else:
        start = 0

    ds = SyntheticTokens(vocab_size=cfg.vocab_size, seq_len=args.seq,
                         global_batch=args.batch)
    wd = StepWatchdog()
    for i in range(start, args.steps):
        wd.start()
        batch = {"tokens": torch.from_numpy(ds.batch_at(i)).to(dev)}
        model, opt, mets = step_fn(model, opt, batch)
        loss = float(mets["loss"])
        straggler = wd.stop(i)
        if i % 5 == 0 or i == args.steps - 1:
            print(f"step {i:4d} loss={loss:.4f}"
                  + ("  [straggler]" if straggler else ""), flush=True)
        if (i + 1) % args.ckpt_every == 0:
            mgr.save(i + 1, train_state(model, opt, keep=mgr.writer),
                     meta={"step": i + 1})
    mgr.wait()
    print("done", flush=True)
    if own_group and dist.is_initialized():
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
