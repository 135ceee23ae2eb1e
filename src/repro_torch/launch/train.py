"""Training launcher: checkpointing, auto-resume, straggler watchdog.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-4b \\
        --steps 100 [--smoke] [--device cpu]

Counterpart of :mod:`repro.launch.train` on one card: the model is built
from seed 0 (f32 parameters, bf16 compute, ``remat="full"``, the flash
kernel with chunk ``min(1024, seq)``), batches come from
:class:`~repro_torch.data.SyntheticTokens`, and a run resumes from the
newest complete checkpoint in ``--ckpt-dir``.  ``--device`` defaults to
``cuda`` and raises without a card; ``--smoke`` (the reduced config) on
``--device cpu`` is the path that runs without one.  ``--model-parallel``
above 1 waits for ``sharding/rules.py`` and raises.
"""
from __future__ import annotations

import argparse
import os
import tempfile

import torch

from ..config import RunConfig, get_config
from ..core.graph import resolve_device
from ..data import SyntheticTokens
from ..models.convert import from_jax_params
from ..models.transformer import init_model
from ..train import (CheckpointManager, adamw_init, make_train_step,
                     restore_train_state, train_state)
from ..train.elastic import StepWatchdog


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
                    help="TP degree; above 1 waits for sharding/rules.py")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if args.model_parallel > 1:
        raise NotImplementedError(
            "--model-parallel > 1 needs sharding/rules.py, not ported yet")
    dev = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    run = RunConfig(attention_chunk=min(1024, args.seq))
    print(f"device={dev} params={cfg.param_count() / 1e6:.1f}M", flush=True)

    gen = torch.Generator(device=dev).manual_seed(0)
    model = from_jax_params(cfg, init_model(cfg, gen), run=run, device=dev,
                            trainable=True)
    opt = adamw_init(dict(model.named_parameters()))
    step_fn = make_train_step(cfg, run, microbatch=args.microbatch or None,
                              total_steps=args.steps,
                              warmup=max(2, args.steps // 10))

    mgr = CheckpointManager(args.ckpt_dir, keep=2)
    start = mgr.latest_step()
    if start is not None:
        opt = restore_train_state(model, mgr.restore(start, device=dev)[0],
                                  start)
        print(f"resume from step {start}", flush=True)
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
            mgr.save(i + 1, train_state(model, opt), meta={"step": i + 1})
    mgr.wait()
    print("done", flush=True)


if __name__ == "__main__":
    main()
