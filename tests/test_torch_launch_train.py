"""The training launcher (``python -m repro_torch.launch.train``) and the
example twins (``examples/train_lm_torch.py``,
``examples/quickstart_torch.py``) at a small size on the CPU: a few steps,
a crash after a checkpoint, a resume that ends where the uninterrupted
run ends (bit-identical checkpoints)."""
import importlib.util
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from repro_torch.launch import train as launch
from repro_torch.train import CheckpointManager

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _example(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "examples", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _trees(directory, step):
    return CheckpointManager(str(directory)).restore(step, device="cpu")[0]


def _crash_and_resume(tmp_path, run, args, capsys):
    """Run to step 6 with checkpoints at 2, 4, 6 (keep 2); drop step 6 (a
    crash after the step-4 save); run again: it resumes from 4 and writes
    a step 6 equal to the first one."""
    first = tmp_path / "first"
    run([*args, "--ckpt-dir", str(first)])
    assert CheckpointManager(str(first)).all_steps() == [4, 6]
    want = _trees(first, 6)
    shutil.rmtree(first / "step_0000000006")
    capsys.readouterr()
    run([*args, "--ckpt-dir", str(first)])
    out = capsys.readouterr().out
    assert "from" in out and "step 4" in out
    got = _trees(first, 6)
    for tname in ("params", "m", "v"):
        assert set(got[tname]) == set(want[tname])
        for k, v in want[tname].items():
            assert np.array_equal(got[tname][k].numpy(), v.numpy()), k


def test_launcher_runs_and_resumes(tmp_path, capsys):
    args = ["--arch", "qwen3-4b", "--smoke", "--device", "cpu", "--steps",
            "6", "--seq", "16", "--batch", "4", "--ckpt-every", "2"]
    cli = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *args,
         "--ckpt-dir", str(tmp_path / "cli")],
        env={**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")},
        capture_output=True, text=True, timeout=600)
    assert cli.returncode == 0, cli.stderr[-2000:]
    assert "step    0 loss=" in cli.stdout and "done" in cli.stdout
    _crash_and_resume(tmp_path, launch.main, args, capsys)


def test_launcher_microbatch_and_refusals(tmp_path):
    launch.main(["--arch", "rwkv6-3b", "--smoke", "--device", "cpu",
                 "--steps", "2", "--seq", "16", "--batch", "4",
                 "--microbatch", "2", "--ckpt-every", "2", "--ckpt-dir",
                 str(tmp_path)])
    assert CheckpointManager(str(tmp_path)).all_steps() == [2]
    # TP 2 needs two ranks: without a process group there is one
    with pytest.raises(ValueError, match="process group"):
        launch.main(["--smoke", "--device", "cpu", "--model-parallel", "2"])


def test_train_lm_example_runs_and_resumes(tmp_path, capsys):
    args = ["--device", "cpu", "--steps", "6", "--width", "64", "--layers",
            "2", "--seq", "16", "--batch", "4", "--ckpt-every", "2"]
    _crash_and_resume(tmp_path, _example("train_lm_torch").main, args,
                      capsys)


def test_quickstart_example(capsys):
    qs = _example("quickstart_torch")
    qs.main(["--device", "cpu", "--scale", "6", "--steps", "10"])
    out = capsys.readouterr().out
    assert "== C(n,3)" in out and "fused pass" in out
    losses = [float(line.split("loss=")[1]) for line in out.splitlines()
              if "loss=" in line]
    assert len(losses) == 10 and np.isfinite(losses).all()
