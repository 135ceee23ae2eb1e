"""The port's training loss and gradients against the JAX package, every
family at its ``:smoke`` config in f32 (cases: ``torch_train_cases.py``).

Both packages take the same weights (JAX's ``init_model``, with the leaves
JAX initialises to 0 or 1 redrawn so that their gradients count) and the
same numpy-drawn batch.  The port's loss and every gradient (mapped back
to the JAX keys by ``to_jax_params``) are held to JAX's
``value_and_grad(make_loss_fn)``: the loss within 1e-4 of its magnitude,
each gradient within 1e-4 of that leaf's largest magnitude (at least 1e-3
of the largest of all leaves), under ``"chunked_causal"`` and ``"dense"``;
the port's ``"flash"`` (its plain version on the CPU, the backward through
the twin) against JAX's ``"chunked_causal"``.  Whatever the remat, a
train step launches flash once per attention call.
"""
import numpy as np
import pytest
import torch
from torch_train_cases import (ARCHS, HELD_TO, case, jax_value_and_grad,
                               port, scaled_errs)

from repro_torch.config import RunConfig, get_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.models.convert import from_jax_params
from repro_torch.train import make_grad_fn, make_loss_fn


@pytest.mark.parametrize("impl", sorted(HELD_TO))
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(arch, impl):
    want_loss, want = jax_value_and_grad(arch, HELD_TO[impl])
    loss, mets, got = port(arch, impl)
    assert set(got) == set(want)
    assert abs(loss - want_loss) <= 1e-4 * max(1.0, abs(want_loss))
    assert np.isfinite(float(mets["ce"])) and np.isfinite(float(mets["aux"]))
    errs = scaled_errs(got, want)
    worst = max(errs, key=errs.get)
    assert errs[worst] <= 1e-4, (worst, errs[worst])
    assert all(np.isfinite(g).all() for g in got.values())


@pytest.mark.parametrize("arch", ["qwen3-4b", "zamba2-1.2b",
                                  "deepseek-v2-236b"])
@pytest.mark.parametrize("remat", ["none", "full", "dots"])
def test_recomputed_blocks_do_not_launch_flash_again(arch, remat,
                                                     monkeypatch):
    """One forward launch per attention call, whatever the remat: the
    checkpoint policy keeps the flash operator's output, and the backward
    recomputes through the twin, not the kernel."""
    calls = []
    forward = fa._forward

    def counted(*args):
        calls.append(1)
        return forward(*args)

    monkeypatch.setattr(fa, "_forward", counted)
    cfg = get_config(arch, smoke=True)
    port(arch, "flash", remat=remat)
    from repro_torch.models.transformer import Transformer
    with torch.device("meta"):
        n_calls = len(Transformer(cfg, RunConfig()).attention_calls())
    assert len(calls) == n_calls > 0


@pytest.mark.parametrize("arch", ["qwen3-4b", "zamba2-1.2b"])
def test_full_remat_backward_twice(arch, monkeypatch):
    """A second backward through one forward under remat ``"full"``
    recomputes the blocks again and replays the same recorded flash
    outputs: the same gradients, and no launch after the forward."""
    calls = []
    forward = fa._forward

    def counted(*args):
        calls.append(1)
        return forward(*args)

    monkeypatch.setattr(fa, "_forward", counted)
    cfg, _, params, batch = case(arch)
    run = RunConfig(attention_impl="flash", attention_chunk=16,
                    remat="full", compute_dtype="float32")
    model = from_jax_params(cfg, params, run=run, device="cpu",
                            trainable=True)
    loss, _ = make_loss_fn(cfg, run)(
        model, {k: torch.from_numpy(v) for k, v in batch.items()})
    n = len(calls)
    ps = list(model.parameters())
    first = torch.autograd.grad(loss, ps, retain_graph=True,
                                allow_unused=True)
    second = torch.autograd.grad(loss, ps, allow_unused=True)
    assert len(calls) == n > 0
    for a, b in zip(first, second):
        assert (a is None) == (b is None)
        assert a is None or torch.equal(a, b)


def test_microbatch_must_divide_the_batch():
    cfg, _, params, batch = case("qwen3-4b")
    run = RunConfig(attention_impl="dense", compute_dtype="float32")
    model = from_jax_params(cfg, params, run=run, device="cpu",
                            trainable=True)
    with pytest.raises(ValueError, match="microbatches"):
        make_grad_fn(cfg, run, microbatch=3)(
            model, {"tokens": torch.from_numpy(batch["tokens"])})


def test_loss_rejects_a_model_built_for_another_run():
    cfg, _, params, batch = case("qwen3-4b")
    model = from_jax_params(cfg, params, device="cpu", trainable=True,
                            run=RunConfig(attention_impl="dense"))
    with pytest.raises(ValueError, match="built for"):
        make_grad_fn(cfg, RunConfig())(
            model, {"tokens": torch.from_numpy(batch["tokens"])})
