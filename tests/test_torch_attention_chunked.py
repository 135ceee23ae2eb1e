"""The chunked attention twins (``"chunked"``, ``"chunked_causal"``), the
flash kernel under autograd (:class:`FlashAttentionFunction`) and the
ring-wrap refusal.

The twins are held to JAX's ``_chunked_attention`` on cacheless inputs
(outputs and gradients, f32, within 2e-5: the kernels' tolerance), and to
the port's ``"dense"`` on a multi-token write into a cache at
``cache_pos`` > 0, where JAX's triangular twin slices kv by row index and
is wrong.  The Function's gradient is held to autograd of the plain
version on the CPU (2e-5), and on the card (``cuda`` marker) to the same
within 2e-2 scaled in bf16 and 1e-4 scaled in f32.  Inputs are drawn with
numpy.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.config import RunConfig, get_config
from repro_torch.kernels.flash_attention import (FlashAttentionFunction,
                                                 flash_attention)
from repro_torch.kernels.ref import flash_attention_ref
from repro_torch.models import attention as tattn
from repro_torch.models.convert import from_jax_params
from repro_torch.models.transformer import init_cache, init_model
from repro_torch.serve import make_prefill_cache_step, make_prefill_step

TOL = 2e-5


def _inputs(B, T, S, H, Hkv, D, seed, q0=0):
    """f32 numpy q, k, v; positions q0..q0+T-1 and 0..S-1."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, T, H, D), dtype=np.float32)
    k = rng.standard_normal((B, S, Hkv, D), dtype=np.float32)
    v = rng.standard_normal((B, S, Hkv, D), dtype=np.float32)
    q_pos = np.tile(np.arange(q0, q0 + T, dtype=np.int32), (B, 1))
    kv_pos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    return q, k, v, q_pos, kv_pos


def _t(arrays, requires_grad=False):
    out = [torch.from_numpy(a.copy()) for a in arrays]
    for t in out[:3]:
        t.requires_grad_(requires_grad)
    return out


def _err(a, b):
    return float(np.abs(np.asarray(a, np.float32)
                        - np.asarray(b, np.float32)).max())


# (B, T, H, Hkv, D, chunk, window): whole chunks, as JAX's twin needs
SHAPES = [(2, 32, 4, 2, 16, 8, None), (1, 64, 4, 1, 32, 16, None),
          (2, 48, 4, 4, 16, 16, 20), (2, 32, 8, 2, 24, 32, None),
          (1, 40, 2, 2, 16, 8, 5)]


@pytest.mark.parametrize("triangular", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_twin_matches_jax(shape, triangular):
    """Cacheless: outputs and q, k, v gradients of the port's twin against
    ``jax.grad`` of JAX's ``_chunked_attention``."""
    import jax
    import jax.numpy as jnp
    from repro.models import attention as jattn

    B, T, H, Hkv, D, chunk, window = shape
    arrays = _inputs(B, T, T, H, Hkv, D, seed=T + D)
    rng = np.random.default_rng(7)
    g_out = rng.standard_normal((B, T, H, D), dtype=np.float32)

    def jf(q, k, v):
        o = jattn._chunked_attention(q, k, v, jnp.asarray(arrays[3]),
                                     jnp.asarray(arrays[4]), window, chunk,
                                     triangular=triangular)
        return jnp.sum(o * g_out), o

    (_, want), jg = jax.value_and_grad(jf, argnums=(0, 1, 2), has_aux=True)(
        *map(jnp.asarray, arrays[:3]))
    q, k, v, qp, kp = _t(arrays, requires_grad=True)
    got = tattn._chunked_attention(q, k, v, qp, kp, window, chunk,
                                   triangular=triangular)
    grads = torch.autograd.grad(got, (q, k, v), torch.from_numpy(g_out))
    assert _err(got.detach(), want) <= TOL
    for g, w in zip(grads, jg):
        assert _err(g, w) <= TOL


@pytest.mark.parametrize("impl", ["chunked", "chunked_causal"])
@pytest.mark.parametrize("T,S,chunk,window", [(37, 37, 8, None),
                                              (100, 100, 16, 30),
                                              (16, 32, 8, None),
                                              (5, 64, 4, 9)])
def test_twin_matches_dense_on_any_positions(impl, T, S, chunk, window):
    """Ragged blocks and queries at the end of a longer cache (a write at
    ``cache_pos`` S - T): the twins equal the dense reference."""
    arrays = _inputs(2, T, S, 4, 2, 16, seed=S, q0=S - T)
    q, k, v, qp, kp = _t(arrays)
    want = tattn._dense_attention(q, k, v, qp, kp, window)
    got = tattn.attention_core(q, k, v, qp, kp, impl=impl, window=window,
                               chunk=chunk)
    assert _err(got, want) <= TOL


def test_jax_triangular_twin_is_wrong_past_slot_zero():
    """The reference's fault the port does not copy: JAX's triangular twin
    slices kv by row index, so queries at the end of a longer cache lose
    the keys after their row index."""
    import jax.numpy as jnp
    from repro.models import attention as jattn

    arrays = _inputs(2, 16, 32, 4, 2, 16, seed=3, q0=16)
    want = tattn._dense_attention(*_t(arrays), None)
    jax_out = jattn._chunked_attention(*map(jnp.asarray, arrays), None, 8,
                                       triangular=True)
    got = tattn._chunked_attention(*_t(arrays), None, 8, triangular=True)
    assert _err(jax_out, want) > 0.1
    assert _err(got, want) <= TOL


@pytest.mark.parametrize("impl", ["chunked", "chunked_causal"])
@pytest.mark.parametrize("arch", ["qwen3-4b", "zamba2-1.2b"])
def test_multi_token_write_at_cache_pos_matches_dense(arch, impl):
    """16 tokens prefilled, then 16 more at ``cache_pos`` 16: the second
    part's logits equal the cacheless ``"dense"`` forward's (1e-4)."""
    cfg = get_config(arch, smoke=True)
    params = init_model(cfg, torch.Generator().manual_seed(0))
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (2, 32)).astype(np.int32))
    dense = RunConfig(attention_impl="dense", compute_dtype="float32")
    full = make_prefill_step(cfg, dense)(
        from_jax_params(cfg, params, run=dense, device="cpu"), toks)
    run = RunConfig(attention_impl=impl, attention_chunk=8,
                    compute_dtype="float32")
    model = from_jax_params(cfg, params, run=run, device="cpu")
    cache = init_cache(cfg, 2, 32, dtype=torch.float32, device="cpu")
    _, cache = make_prefill_cache_step(cfg, run)(model, toks[:, :16], cache)
    pos = torch.arange(16, 32, dtype=torch.int32).repeat(2, 1)
    with torch.inference_mode():
        second, _, _ = model(toks[:, 16:], pos, cache, 16)
    assert _err(second, full[:, 16:]) <= 1e-4


def test_remat_rows_keeps_the_gradient():
    arrays = _inputs(2, 64, 64, 4, 2, 16, seed=11)
    grads = []
    for remat_rows in (False, True):
        q, k, v, qp, kp = _t(arrays, requires_grad=True)
        out = tattn._chunked_attention(q, k, v, qp, kp, None, 16,
                                       triangular=True, remat_rows=remat_rows)
        grads.append(torch.autograd.grad(out.square().sum(), (q, k, v)))
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def test_visible_blocks_skip_by_position():
    """Blocks are kept by position: a ring whose slots hold positions out
    of order keeps the block holding the visible keys."""
    q_pos = torch.tensor([[20, 21, 22, 23]], dtype=torch.int32)
    kv_pos = torch.tensor([[16, 17, 18, 19, 20, 21, 22, 23, 8, 9, 10, 11,
                            24, 25, 26, 2**30]], dtype=torch.int32)
    assert tattn._visible_blocks(q_pos, kv_pos, None, 4, 4) == [
        [True, True, True, False]]
    assert tattn._visible_blocks(q_pos, kv_pos, 8, 4, 4) == [
        [True, True, False, False]]


# --------------------------------------------------------------------------
# the flash kernel under autograd
# --------------------------------------------------------------------------

FLASH_CASES = {  # (B, T, S, H, Hkv, D, q0), window, chunk
    "square": ((2, 37, 37, 4, 2, 16, 0), None, 8),
    "window": ((2, 50, 50, 4, 1, 32, 0), 12, 16),
    "offset": ((2, 20, 45, 4, 4, 24, 25), None, 8),
    "gqa_g4": ((1, 64, 64, 8, 2, 16, 0), None, 64),
}


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_function_gradient_equals_plain_autograd(case):
    shape, window, chunk = FLASH_CASES[case]
    arrays = _inputs(*shape[:6], seed=len(case), q0=shape[6])
    g_out = torch.from_numpy(np.random.default_rng(9).standard_normal(
        shape[:2] + shape[3:4] + shape[5:6], dtype=np.float32))
    q, k, v, qp, kp = _t(arrays, requires_grad=True)
    before = flash_attention.launches
    got = flash_attention(q, k, v, qp, kp, window=window, chunk=chunk)
    assert got.grad_fn is not None
    assert type(got.grad_fn).__name__ == "FlashAttentionFunctionBackward"
    g_got = torch.autograd.grad(got, (q, k, v), g_out)
    want = flash_attention_ref(q, k, v, qp, kp, window=window)
    g_want = torch.autograd.grad(want, (q, k, v), g_out)
    assert _err(got.detach(), want.detach()) <= TOL
    for a, b in zip(g_got, g_want):
        assert _err(a, b) <= TOL
    assert flash_attention.launches == before  # the CPU counts no launch


def test_flash_function_only_where_autograd_records():
    arrays = _inputs(1, 8, 8, 2, 2, 16, seed=1)
    q, k, v, qp, kp = _t(arrays)
    assert flash_attention(q, k, v, qp, kp).grad_fn is None
    q.requires_grad_(True)
    with torch.no_grad():
        assert flash_attention(q, k, v, qp, kp).grad_fn is None
    with torch.inference_mode():
        assert flash_attention(q, k, v, qp, kp).grad_fn is None
    out = flash_attention(q, k, v, qp, kp)  # only q requires grad
    dq, = torch.autograd.grad(out.sum(), (q,))
    assert dq.shape == q.shape and out.grad_fn is not None


def test_flash_forward_is_one_operator():
    """The Function's forward goes through the registered operator, the
    name a checkpoint policy keeps."""
    arrays = _inputs(1, 8, 8, 2, 2, 16, seed=2)
    q, k, v, qp, kp = _t(arrays)
    want = flash_attention_ref(q, k, v, qp, kp)
    got = torch.ops.repro_torch.flash_attention(q, k, v, qp, kp, 0)
    assert torch.equal(got, want)
    q.requires_grad_(True)
    assert torch.equal(FlashAttentionFunction.apply(
        q, k, v, qp, kp, None, 8).detach(), want)


# --------------------------------------------------------------------------
# the ring: a multi-token write must not overwrite keys still in view
# --------------------------------------------------------------------------

def _danube():
    cfg = get_config("h2o-danube-3-4b", smoke=True)  # window 16
    run = RunConfig(attention_impl="dense", compute_dtype="float32")
    model = from_jax_params(cfg, init_model(
        cfg, torch.Generator().manual_seed(1)), run=run, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (1, 40)).astype(np.int32))
    return cfg, run, model, toks


def test_ring_refuses_a_write_that_loses_visible_keys():
    cfg, run, model, toks = _danube()
    cache = init_cache(cfg, 1, 64, dtype=torch.float32, device="cpu")
    assert cache["layers"].pos.shape[-1] == cfg.sliding_window == 16
    _, cache = make_prefill_cache_step(cfg, run)(model, toks[:, :16], cache)
    pos = torch.arange(16, 32, dtype=torch.int32)[None]
    with torch.inference_mode(), pytest.raises(ValueError,
                                               match="earlier queries"):
        model(toks[:, 16:32], pos, cache, 16)
    # a 2-token write past the wrap replaces the key position 17 sees
    with torch.inference_mode(), pytest.raises(ValueError,
                                               match="earlier queries"):
        model(toks[:, 16:18], pos[:, :2], cache, 16)


def test_ring_takes_writes_that_lose_nothing():
    """Single tokens across the wrap, and a multi-token write that ends
    before it, equal the cacheless forward."""
    cfg, run, model, toks = _danube()
    full = make_prefill_step(cfg, run)(model, toks[:, :24])
    cache = init_cache(cfg, 1, 64, dtype=torch.float32, device="cpu")
    first, cache = make_prefill_cache_step(cfg, run)(model, toks[:, :10],
                                                     cache)
    out = [first]
    with torch.inference_mode():
        lg, _, _ = model(toks[:, 10:16], torch.arange(
            10, 16, dtype=torch.int32)[None], cache, 10)
        out.append(lg)
        for t in range(16, 24):
            lg, _, _ = model(toks[:, t:t + 1], torch.tensor(
                [[t]], dtype=torch.int32), cache, t)
            out.append(lg)
    assert _err(torch.cat(out, 1), full) <= 1e-4


def test_ring_loss_rule():
    # window = ring of 16: any write of >= 2 keys after the wrap loses one
    assert tattn._ring_loss(2, 16, 16, 16)
    assert not tattn._ring_loss(1, 40, 16, 16)
    assert not tattn._ring_loss(6, 10, 16, 16)  # ends at slot 15
    # no window (the cache is max_seq long): a wrapped write always loses
    assert tattn._ring_loss(2, 64, 32, None)
    # a ring larger than the window: the replaced keys have left the window
    assert not tattn._ring_loss(4, 32, 32, 16)
    assert tattn._ring_loss(20, 32, 32, 16)


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the flash kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_function_on_the_card(cuda_device, case, dtype, tol):
    """The kernel's forward and the recomputed backward against autograd
    of the plain version on the same inputs, scaled by max(1, |want|)."""
    shape, window, chunk = FLASH_CASES[case]
    arrays = _inputs(*shape[:6], seed=len(case), q0=shape[6])
    ins = [torch.from_numpy(a).to(cuda_device) for a in arrays]
    q, k, v = (t.to(dtype).requires_grad_() for t in ins[:3])
    g_out = torch.randn(q.shape, device=cuda_device, dtype=dtype,
                        generator=torch.Generator(cuda_device).manual_seed(0))
    before = flash_attention.launches
    got = flash_attention(q, k, v, *ins[3:], window=window, chunk=chunk)
    g_got = torch.autograd.grad(got, (q, k, v), g_out)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1  # the backward launches none
    want = flash_attention_ref(q, k, v, *ins[3:], window=window)
    g_want = torch.autograd.grad(want, (q, k, v), g_out)
    for a, b in [(got, want), *zip(g_got, g_want)]:
        err = (a.float() - b.float()).abs() / b.float().abs().clamp(min=1.0)
        assert float(err.max()) < tol


def test_run_config_takes_the_training_knobs():
    run = RunConfig(attention_impl="chunked_causal", attention_chunk=64,
                    remat="dots", remat_attention=True, microbatch=2,
                    grad_compression="int8")
    assert dataclasses.replace(run, attention_impl="chunked").remat == "dots"
    for bad in (dict(attention_impl="pallas"), dict(remat="some"),
                dict(grad_compression="fp8"), dict(attention_chunk=0),
                dict(microbatch=0)):
        with pytest.raises(ValueError):
            RunConfig(**bad)
