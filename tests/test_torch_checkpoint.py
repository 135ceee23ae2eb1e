"""Checkpoints: the port's ``CheckpointManager`` in the JAX package's
on-disk format (a checkpoint written by either restores in the other,
bit-exact), atomic renames and auto-resume, a resume equal to the
uninterrupted run, and the elasticity helpers."""
import os
import time

import numpy as np
import pytest
import torch

from repro_torch.config import RunConfig, get_config
from repro_torch.data import SyntheticTokens
from repro_torch.models.convert import from_jax_params, to_jax_params
from repro_torch.models.transformer import init_model
from repro_torch.train import (CheckpointManager, adamw_init, make_train_step,
                               restore_train_state, train_state)
from repro_torch.train.elastic import StepWatchdog, plan_elastic_mesh

ARCH = "musicgen-large"


def _state(seed=0):
    """A trained-looking state: the model after one step, its moments."""
    cfg = get_config(ARCH, smoke=True)
    run = RunConfig(attention_impl="dense", remat="none",
                    compute_dtype="float32", learning_rate=1e-3)
    model = from_jax_params(cfg, init_model(
        cfg, torch.Generator().manual_seed(seed)), run=run, device="cpu",
        trainable=True)
    opt = adamw_init(dict(model.named_parameters()))
    ds = SyntheticTokens(vocab_size=cfg.vocab_size, seq_len=16,
                         global_batch=4)
    step = make_train_step(cfg, run, warmup=2)
    model, opt, _ = step(model, opt, {"tokens": torch.from_numpy(
        ds.batch_at(0))})
    return cfg, run, model, opt, ds, step


def test_port_checkpoint_restores_in_jax(tmp_path):
    from repro.train import CheckpointManager as JaxManager

    _, _, model, opt, _, _ = _state()
    trees = train_state(model, opt)
    CheckpointManager(str(tmp_path), async_save=False).save(
        7, trees, meta={"step": 7, "note": "port"})
    mgr = JaxManager(str(tmp_path))
    assert mgr.latest_step() == 7
    got, meta = mgr.restore(7)
    assert meta == {"step": 7, "note": "port"}
    assert set(got) == set(trees)
    for tname, tree in trees.items():
        assert set(got[tname]) == set(tree)
        for k, v in tree.items():
            w = np.asarray(got[tname][k])
            assert w.dtype == v.numpy().dtype
            np.testing.assert_array_equal(w, v.numpy())


def test_jax_checkpoint_restores_in_the_port(tmp_path):
    import jax
    from repro.config import get_config as jax_get_config
    from repro.models import transformer as jtfm
    from repro.train import CheckpointManager as JaxManager
    from repro.train import adamw_init as jax_adamw_init

    params = jtfm.init_model(jax_get_config(ARCH, smoke=True),
                             jax.random.PRNGKey(3))
    opt = jax_adamw_init(params)
    m = {k: v + 0.25 for k, v in opt.m.items()}
    JaxManager(str(tmp_path), async_save=False).save(
        4, {"params": params, "m": m, "v": opt.v}, meta={"step": 4})
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.latest_step() == 4
    trees, meta = mgr.restore(4, device="cpu")
    assert meta == {"step": 4}
    for tname, want in (("params", params), ("m", m), ("v", opt.v)):
        assert set(trees[tname]) == set(want)
        for k, v in want.items():
            np.testing.assert_array_equal(trees[tname][k].numpy(),
                                          np.asarray(v))
    # and into a module: every parameter bit-exact
    cfg = get_config(ARCH, smoke=True)
    model = from_jax_params(cfg, trees["params"], device="cpu",
                            trainable=True)
    back = to_jax_params(model)
    for k, v in params.items():
        np.testing.assert_array_equal(back[k].numpy(), np.asarray(v))


def test_async_save_and_gc(tmp_path):
    _, _, model, opt, _, _ = _state()
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=True)
    for s in (1, 2, 3, 4):
        mgr.save(s, {"params": to_jax_params(model)})
    mgr.wait()
    assert mgr.all_steps() == [3, 4]
    assert sorted(os.listdir(tmp_path)) == ["step_0000000003",
                                            "step_0000000004"]


def test_crash_mid_save_leaves_latest_valid(tmp_path):
    """A directory without a manifest (a crash before the rename, or a
    half-written step directory) is not a checkpoint."""
    _, _, model, opt, _, _ = _state()
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(5, train_state(model, opt), meta={"step": 5})
    crash = tmp_path / "step_0000000009"
    (crash / "params").mkdir(parents=True)
    (tmp_path / "tmp.10" / "params").mkdir(parents=True)
    assert mgr.latest_step() == 5
    trees, meta = mgr.restore(mgr.latest_step(), device="cpu")
    assert meta["step"] == 5 and set(trees) == {"params", "m", "v"}


def test_resume_equals_the_uninterrupted_run(tmp_path):
    """Six steps straight against three, a checkpoint, a fresh process
    state restored from it, and three more: bit-identical parameters and
    moments (the stream replays from the step)."""
    cfg, run, model, opt, ds, step = _state()
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    for i in range(1, 6):
        model, opt, _ = step(model, opt, {"tokens": torch.from_numpy(
            ds.batch_at(i))})
        if i == 2:
            mgr.save(3, train_state(model, opt), meta={"step": 3})
    mgr.wait()

    _, _, model2, _, _, _ = _state(seed=9)  # other weights, overwritten
    trees, meta = CheckpointManager(str(tmp_path)).restore(3, device="cpu")
    opt2 = restore_train_state(model2, trees, meta["step"])
    for i in range(meta["step"], 6):
        model2, opt2, _ = step(model2, opt2, {"tokens": torch.from_numpy(
            ds.batch_at(i))})
    assert opt2.step == opt.step == 6
    for a, b in zip(train_state(model, opt).values(),
                    train_state(model2, opt2).values()):
        for k in a:
            assert torch.equal(a[k], b[k]), k


def test_restore_defaults_to_the_card(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(1, {"params": {"a": np.ones(3, np.float32)}})
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            mgr.restore(1)


def test_elastic_plan():
    from repro.train.elastic import plan_elastic_mesh as jax_plan

    for n, mp in ((512, 16), (256, 16), (496, 16), (8, 2), (7, 1)):
        assert plan_elastic_mesh(n, mp) == jax_plan(n, mp)
    with pytest.raises(ValueError):
        plan_elastic_mesh(8)


def test_watchdog_flags_straggler():
    wd = StepWatchdog(factor=3.0)
    for i in range(10):
        wd.start()
        time.sleep(0.002)
        assert not wd.stop(i)
    wd.start()
    time.sleep(0.05)
    assert wd.stop(99)
    assert wd.stragglers and wd.stragglers[0][0] == 99
    assert wd.median > 0
