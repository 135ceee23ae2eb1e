"""The port's training loop against the JAX package and itself, every
family at its ``:smoke`` config in f32 (cases: ``torch_train_cases.py``):
the remat modes give the same gradients within 1e-6 (scaled by max(1,
|g|)); ``microbatch=2`` gives the full batch's gradients within 1e-5 of
each leaf's largest magnitude; RWKV's scan takes the same numbers on its
two paths (in place, out of place) and JAX's gradient (1e-4 scaled).
"""
import numpy as np
import pytest
import torch
from torch_train_cases import ARCHS, case, port, scaled_errs

from repro_torch.models import rwkv as trwkv


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_modes_give_the_same_gradients(arch):
    impl = "flash"
    base = port(arch, impl, remat="none")[2]
    for remat in ("full", "dots"):
        got = port(arch, impl, remat=remat)[2]
        for k, w in base.items():
            err = np.abs(got[k] - w) / np.maximum(np.abs(w), 1.0)
            assert float(err.max()) <= 1e-6, (remat, k)


@pytest.mark.parametrize("arch", ["musicgen-large", "granite-moe-3b-a800m",
                                  "rwkv6-3b", "zamba2-1.2b", "pixtral-12b"])
def test_microbatch_matches_full_batch(arch):
    """Two microbatches of 2 rows against the 4-row batch: gradients and
    loss (MoE families: the capacity is per call, so granite routes two
    2-row batches as JAX's scan does; both packages agree there, and the
    full batch differs only by the drops)."""
    cfg, _, _, b = case(arch)
    rng = np.random.default_rng(7)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (4, 17)).astype(
        np.int32)}
    if cfg.n_prefix_embeds:
        batch["prefix_embeds"] = rng.standard_normal(
            (4, cfg.n_prefix_embeds, cfg.d_model), dtype=np.float32)
    full_loss, _, full = port(arch, "dense", batch=batch)
    loss, _, micro = port(arch, "dense", microbatch=2, batch=batch)
    if cfg.moe is not None:  # drops differ between 16- and 32-token calls
        halves = [port(arch, "dense", batch={k: v[i:i + 2]
                                              for k, v in batch.items()})
                  for i in (0, 2)]
        full_loss = (halves[0][0] + halves[1][0]) / 2
        full = {k: (halves[0][2][k] + halves[1][2][k]) / 2 for k in full}
    assert abs(loss - full_loss) <= 1e-5 * max(1.0, abs(full_loss))
    errs = scaled_errs(micro, full)
    worst = max(errs, key=errs.get)
    assert errs[worst] <= 1e-5, (worst, errs[worst])


# --------------------------------------------------------------------------
# RWKV's chunked scan under autograd
# --------------------------------------------------------------------------

def _wkv_inputs(Bw, Tw, H, D, seed):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((Bw, Tw, H, D), dtype=np.float32)
               for _ in range(3))
    w_log = -np.exp(rng.standard_normal((Bw, Tw, H, D)) * 0.5).astype(
        np.float32)
    u = (rng.standard_normal((H, D)) * 0.1).astype(np.float32)
    s0 = rng.standard_normal((Bw, H, D, D), dtype=np.float32)
    return r, k, v, w_log, u, s0


@pytest.mark.parametrize("Tw,chunk", [(32, 8), (37, 16)])
def test_wkv_chunked_paths_are_equal(Tw, chunk):
    """The serving path's in-place decay passes and the autograd path's
    out-of-place ones give the same numbers, bit for bit."""
    arrays = _wkv_inputs(2, Tw, 3, 8, seed=Tw)
    with torch.no_grad():
        o1, s1 = trwkv.wkv_chunked(*map(torch.from_numpy, arrays[:5]), chunk,
                                   torch.from_numpy(arrays[5]))
    ins = [torch.from_numpy(a).requires_grad_() for a in arrays]
    o2, s2 = trwkv.wkv_chunked(*ins[:5], chunk, ins[5])
    assert o2.grad_fn is not None
    assert torch.equal(o1, o2.detach()) and torch.equal(s1, s2.detach())


def test_wkv_chunked_gradient_matches_jax():
    import jax
    import jax.numpy as jnp
    from repro.models import rwkv as jrwkv

    arrays = _wkv_inputs(2, 32, 3, 8, seed=5)
    rng = np.random.default_rng(6)
    g_o = rng.standard_normal((2, 32, 3, 8), dtype=np.float32)
    g_s = rng.standard_normal((2, 3, 8, 8), dtype=np.float32)

    def jf(*xs):
        o, S = jrwkv.wkv_chunked(*xs[:5], 8, xs[5])
        return jnp.sum(o * g_o) + jnp.sum(S * g_s)

    want = jax.grad(jf, argnums=tuple(range(6)))(*map(jnp.asarray, arrays))
    ins = [torch.from_numpy(a).requires_grad_() for a in arrays]
    o, S = trwkv.wkv_chunked(*ins[:5], 8, ins[5])
    loss = (o * torch.from_numpy(g_o)).sum() + (S * torch.from_numpy(
        g_s)).sum()
    got = torch.autograd.grad(loss, ins)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert float(np.abs(g.numpy() - w).max()) <= 1e-4 * max(
            1.0, float(np.abs(w).max()))


@pytest.mark.parametrize("arch", ARCHS)
def test_trainable_params_round_trip_bitwise(arch):
    """``from_jax_params(..., trainable=True)`` gives every parameter its
    own contiguous storage (no view of a stacked or transposed table, nor
    the caller's tensor), requiring grad, in train mode; ``to_jax_params``
    gives the table back bit for bit, and ``from_jax_tree`` the module's
    own tensors."""
    from repro_torch.models.convert import (from_jax_params, from_jax_tree,
                                            to_jax_params)

    cfg, _, params, _ = case(arch)
    table = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    model = from_jax_params(cfg, table, device="cpu", trainable=True)
    assert model.training
    storages = set()
    for p in model.parameters():
        assert p.requires_grad and p.is_contiguous()
        storages.add(p.untyped_storage().data_ptr())
    assert len(storages) == len(list(model.parameters()))
    assert not storages & {t.untyped_storage().data_ptr()
                           for t in table.values()}
    back = to_jax_params(model)
    assert set(back) == set(params)
    for k, v in params.items():
        assert back[k].is_contiguous()
        np.testing.assert_array_equal(back[k].numpy(), v, err_msg=k)
    tree = from_jax_tree(model, params)
    for name, p in model.named_parameters():
        assert torch.equal(tree[name], p.detach()), name
