"""End-to-end LM training through the PyTorch port: checkpointing,
auto-resume, watchdog (the twin of ``examples/train_lm.py``).

Default args train a ~10M-param model for 60 steps; ``--device cpu`` runs
without a card (minutes), the default ``cuda`` on one.

    PYTHONPATH=src python examples/train_lm_torch.py --steps 60 --device cpu
    # kill it mid-run and re-run: it resumes from the latest checkpoint.
"""
import argparse
import dataclasses
import os
import tempfile

import torch

from repro_torch.config import RunConfig, get_config
from repro_torch.core.graph import resolve_device
from repro_torch.data import SyntheticTokens
from repro_torch.models.convert import from_jax_params
from repro_torch.models.transformer import init_model
from repro_torch.train import (CheckpointManager, adamw_init, make_train_step,
                               restore_train_state, train_state)
from repro_torch.train.elastic import StepWatchdog


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--width", type=int, default=256)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    base = get_config(args.arch, smoke=True)
    cfg = dataclasses.replace(
        base, n_layers=args.layers, d_model=args.width,
        n_heads=max(4, args.width // 64), n_kv_heads=max(2, args.width // 128),
        d_ff=args.width * 4, head_dim=None, vocab_size=4096)
    run = RunConfig(attention_chunk=128, remat="full", learning_rate=args.lr)
    print(f"model: {cfg.n_layers}L d={cfg.d_model} "
          f"params={cfg.param_count() / 1e6:.1f}M device={dev}")

    mgr = CheckpointManager(args.ckpt_dir, keep=2)
    step_fn = make_train_step(cfg, run, total_steps=args.steps,
                              warmup=max(args.steps // 10, 2))
    ds = SyntheticTokens(vocab_size=cfg.vocab_size, seq_len=args.seq,
                         global_batch=args.batch)
    model = from_jax_params(cfg, init_model(
        cfg, torch.Generator(device=dev).manual_seed(0)), run=run,
        device=dev, trainable=True)
    opt = adamw_init(dict(model.named_parameters()))
    start = mgr.latest_step()
    if start is not None:
        opt = restore_train_state(model, mgr.restore(start, device=dev)[0],
                                  start)
        print(f"resumed from checkpoint step {start}")
    else:
        start = 0

    wd = StepWatchdog()
    for i in range(start, args.steps):
        wd.start()
        batch = {"tokens": torch.from_numpy(ds.batch_at(i)).to(dev)}
        model, opt, mets = step_fn(model, opt, batch)
        loss = float(mets["loss"])
        straggler = wd.stop(i)
        if i % 5 == 0 or i == args.steps - 1:
            print(f"step {i:4d} loss={loss:.4f} "
                  f"gnorm={float(mets['grad_norm']):.3f} "
                  f"lr={mets['lr']:.2e}"
                  + ("  [straggler]" if straggler else ""))
        if (i + 1) % args.ckpt_every == 0:
            mgr.save(i + 1, train_state(model, opt), meta={"step": i + 1})
    mgr.wait()
    print(f"done; checkpoints at {args.ckpt_dir}: {mgr.all_steps()}")
    if wd.stragglers:
        print(f"straggling steps flagged: {wd.stragglers}")


if __name__ == "__main__":
    main()
