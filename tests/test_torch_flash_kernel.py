"""The flash-attention kernel's plain torch version against the JAX Pallas
kernel (interpret mode) and the JAX oracle; the CUDA kernel against the
plain version where a card is present.

Inputs are drawn with numpy and handed to both packages.  Tolerances are
the JAX package's own (``tests/test_kernels.py``): 2e-5 in float32, 2e-2
in bfloat16.  The JAX package is imported inside the tests that compare
with it, so the CUDA cases also run on a machine with the card and no JAX:
``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_flash_kernel.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops as tops
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.ref import flash_attention_ref

SENTINEL = 2**30
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


def _jax():
    """(jax.numpy, the Pallas flash kernel, the JAX oracle)."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels.flash_attention import flash_attention_pallas
    from repro.kernels.ref import flash_attention_ref as oracle
    return jnp, flash_attention_pallas, oracle


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the flash kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(B, T, S, H, Hkv, D, seed, q_pos=None, kv_pos=None):
    """float32 numpy q, k, v and int32 positions (arange by default)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, T, H, D), dtype=np.float32)
    k = rng.standard_normal((B, S, Hkv, D), dtype=np.float32)
    v = rng.standard_normal((B, S, Hkv, D), dtype=np.float32)
    if q_pos is None:
        q_pos = np.broadcast_to(np.arange(T, dtype=np.int32), (B, T))
    if kv_pos is None:
        kv_pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    return q, k, v, np.array(q_pos, order="C"), np.array(kv_pos, order="C")


def _torch(arrays, dtype, device="cpu"):
    q, k, v, qp, kp = arrays
    return ([torch.from_numpy(x).to(device=device, dtype=dtype)
             for x in (q, k, v)]
            + [torch.from_numpy(x).to(device) for x in (qp, kp)])


def _err(a, b):
    return float(np.abs(np.asarray(a, np.float32)
                        - np.asarray(b, np.float32)).max())


# the shapes of tests/test_kernels.py::test_flash_attention_vs_oracle
@pytest.mark.parametrize("B,T,H,Hkv,D,chunk,win,dtype", [
    (2, 128, 4, 2, 64, 64, None, torch.float32),
    (1, 256, 8, 8, 32, 128, None, torch.float32),
    (2, 128, 4, 4, 64, 32, 48, torch.float32),
    (1, 128, 4, 1, 128, 64, None, torch.float32),
    (2, 64, 2, 2, 64, 64, None, torch.bfloat16),
    # MLA's qk head dims (nope + rope): 24 at smoke size, 192 at full width
    (2, 64, 4, 4, 24, 32, None, torch.float32),
    (1, 128, 2, 2, 192, 64, None, torch.float32),
    (1, 64, 2, 2, 192, 32, None, torch.bfloat16),
])
def test_plain_version_matches_pallas_and_oracle(B, T, H, Hkv, D, chunk, win,
                                                 dtype):
    jnp, pallas, oracle = _jax()
    arrays = _inputs(B, T, T, H, Hkv, D, seed=B * T + H)
    got = flash_attention(*_torch(arrays, dtype), window=win)
    assert got.dtype == dtype and got.shape == (B, T, H, D)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jq, jk, jv = (jnp.asarray(x, dtype=jdt) for x in arrays[:3])
    jqp, jkp = (jnp.asarray(x) for x in arrays[3:])
    want_k = pallas(jq, jk, jv, jqp, jkp, window=win, block_q=chunk,
                    block_kv=chunk, interpret=True)
    want_o = oracle(jq, jk, jv, jqp, jkp, window=win)
    got = got.float().numpy()
    assert _err(got, want_k) < TOL[dtype]
    assert _err(got, want_o) < TOL[dtype]


def _ragged_tail():
    """T = 48 with a 32-row chunk: the Pallas kernel leaves rows 32-47
    unwritten here (T // block_q drops the tail)."""
    return _inputs(2, 48, 48, 4, 2, 64, seed=11), None


def _offset_queries():
    """q positions 64..95 over 128 kv slots: the Pallas kernel's
    block-index skip (ki <= qi) drops visible keys here."""
    q_pos = np.broadcast_to(np.arange(64, 96, dtype=np.int32), (1, 32))
    return _inputs(1, 32, 128, 4, 2, 64, seed=12, q_pos=q_pos), None


def _cache_prefill():
    """The prefill-from-cache shape: T prompt slots then SENTINEL slots."""
    kv_pos = np.full((2, 80), SENTINEL, np.int32)
    kv_pos[:, :72] = np.arange(72)
    return _inputs(2, 72, 80, 4, 2, 16, seed=13, kv_pos=kv_pos), None


def _windowed_offset():
    """Window 24 with offset queries and a ragged S, at head dim 120."""
    q_pos = np.broadcast_to(np.arange(30, 70, dtype=np.int32), (2, 40))
    return _inputs(2, 40, 70, 4, 1, 120, seed=14, q_pos=q_pos), 24


UNSOUND = {"ragged_tail": _ragged_tail, "offset_queries": _offset_queries}
EXTRA = {"cache_prefill": _cache_prefill, "windowed_offset": _windowed_offset}


@pytest.mark.parametrize("case", sorted({**UNSOUND, **EXTRA}))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_plain_version_matches_oracle_where_pallas_is_unsound(case, dtype):
    """Shapes the Pallas kernel does not handle (ragged T, offset
    positions) or that it is not tested at: the oracle alone."""
    jnp, _, oracle = _jax()
    arrays, window = {**UNSOUND, **EXTRA}[case]()
    got = flash_attention(*_torch(arrays, dtype), window=window)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    want = oracle(*(jnp.asarray(x, dtype=jdt) for x in arrays[:3]),
                  *(jnp.asarray(x) for x in arrays[3:]), window=window)
    assert _err(got.float().numpy(), want) < TOL[dtype]


@pytest.mark.parametrize("case", sorted(UNSOUND))
def test_pallas_faults_are_not_copied(case):
    """At these shapes the Pallas kernel (chunk 32) disagrees with the
    oracle — NaN tail rows, dropped keys — while the port agrees."""
    jnp, pallas, oracle = _jax()
    arrays, _ = UNSOUND[case]()
    j = [jnp.asarray(x) for x in arrays]
    want = np.asarray(oracle(*j))
    bad = np.asarray(pallas(*j, block_q=32, block_kv=32, interpret=True))
    assert not np.allclose(bad, want, atol=0.1)
    assert _err(flash_attention(*_torch(arrays, torch.float32)), want) < 2e-5


def test_front_door_is_the_wrapper():
    assert tops.flash_attention is flash_attention


@pytest.mark.parametrize("bad", ["head_dim", "dtype", "mixed", "gqa",
                                 "positions", "window"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    q, k, v, qp, kp = _torch(_inputs(1, 8, 8, 4, 2, 16, seed=0),
                             torch.float32)
    if bad == "head_dim":
        q, k, v = q[..., :8], k[..., :8], v[..., :8]
    elif bad == "dtype":
        q, k, v = q.double(), k.double(), v.double()
    elif bad == "mixed":
        k = k.bfloat16()
    elif bad == "gqa":
        q = torch.cat([q, q[:, :, :1]], dim=2)
    elif bad == "positions":
        qp = qp.long()
    with pytest.raises(ValueError):
        flash_attention(q, k, v, qp, kp, window=0 if bad == "window" else None)


def test_cpu_path_does_not_count_launches():
    before = flash_attention.launches
    flash_attention(*_torch(_inputs(1, 8, 8, 2, 2, 16, seed=0),
                            torch.float32))
    assert flash_attention.launches == before


def _edge_tiles():
    """T = 129, S = 257: one row past a 128-row q tile and one key past
    two 128-key kv tiles, with another query offset in each batch row."""
    q_pos = np.stack([np.arange(128, 257), np.arange(61, 190)]).astype(
        np.int32)
    return _inputs(2, 129, 257, 4, 2, 128, seed=21, q_pos=q_pos), None


def _gqa(group):
    """H = group * Hkv: G = 1 (H = Hkv) and G = 8."""
    return lambda: (_inputs(2, 200, 200, 8, 8 // group, 128,
                            seed=22 + group), None)


def _single_query():
    """T = 1 called directly: one query per batch row, 77 keys."""
    q_pos = np.array([[60], [200]], np.int32)
    return _inputs(2, 1, 77, 4, 2, 128, seed=23, q_pos=q_pos), None


def _window_8():
    """A window of 8 keys, smaller than a kv tile, at head dim 128."""
    return _inputs(2, 300, 300, 4, 2, 128, seed=24), 8


def _group(G, D):
    """G query heads a kv head at head dim D: granite (G 3, D 64) and
    deepseek-coder (G 7, D 128)."""
    return lambda: (_inputs(2, 150, 150, 2 * G, 2, D, seed=30 + G), None)


def _mla(T, S):
    """MLA's prefill core: G 1 at head dim 192, one q and one kv tile past
    a multiple of the 64-key tile, offset queries."""
    q_pos = np.broadcast_to(np.arange(S - T, S, dtype=np.int32), (2, T))
    return lambda: (_inputs(2, T, S, 4, 4, 192, seed=40 + T, q_pos=q_pos),
                    None)


def _head_dim(D):
    """Ragged T and S with offset queries at head dim D."""
    q_pos = np.broadcast_to(np.arange(73, 173, dtype=np.int32), (2, 100))
    return lambda: (_inputs(2, 100, 173, 4, 2, D, seed=25 + D, q_pos=q_pos),
                    None)


CUDA_CASES = {
    **UNSOUND, **EXTRA,
    "square": lambda: (_inputs(2, 256, 256, 8, 2, 128, seed=3), None),
    "edge_tiles": _edge_tiles, "gqa_g1": _gqa(1), "gqa_g8": _gqa(8),
    "single_query": _single_query, "window_8": _window_8,
    "gqa_g3_d64": _group(3, 64), "gqa_g7_d128": _group(7, 128),
    "mla_d192": _mla(129, 193), "mla_d192_square": _mla(256, 256),
    **{f"head_dim_{D}": _head_dim(D) for D in (16, 24, 32, 64, 120, 128,
                                               192)},
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CUDA_CASES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_cuda_kernel_matches_plain_version(cuda_device, case, dtype):
    """f32 against the plain version within 2e-5.  bf16 against the plain
    version's f32 output on the same input values, the error scaled by
    max(1, |want|): the plain version's own bf16 output rounds once more,
    so two right answers can sit one bf16 step apart (0.03125 in [4, 8))."""
    arrays, window = CUDA_CASES[case]()
    args = _torch(arrays, dtype, cuda_device)
    before = flash_attention.launches
    got = flash_attention(*args, window=window)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert got.dtype == dtype and got.shape == args[0].shape
    want = flash_attention_ref(*(t.float() for t in args[:3]), *args[3:],
                               window=window)
    err = (got.float() - want).abs()
    if dtype == torch.bfloat16:
        err = err / want.abs().clamp(min=1.0)
    assert float(err.max()) < TOL[dtype]
