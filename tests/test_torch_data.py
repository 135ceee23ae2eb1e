"""The port's data pipeline against the JAX package's: a numpy copy, so
every batch is bit-identical."""
import numpy as np
import pytest

from repro_torch.data import SyntheticTokens, TokenFileDataset


@pytest.mark.parametrize("vocab,seq,batch,seed,shards", [
    (64, 32, 8, 0, 1), (151_936, 128, 4, 3, 2), (20, 7, 6, 11, 3),
    (2, 5, 4, 1, 4)])
def test_synthetic_batches_are_bit_identical(vocab, seq, batch, seed, shards):
    from repro.data import SyntheticTokens as JaxSynthetic

    for shard in range(shards):
        kw = dict(vocab_size=vocab, seq_len=seq, global_batch=batch,
                  seed=seed, shard=shard, n_shards=shards)
        got, want = SyntheticTokens(**kw), JaxSynthetic(**kw)
        assert got.local_batch == want.local_batch == batch // shards
        for step in (0, 1, 7, 1000):
            a, b = got.batch_at(step), want.batch_at(step)
            assert a.dtype == b.dtype == np.int32
            assert a.shape == (batch // shards, seq + 1)
            np.testing.assert_array_equal(a, b)
        it = iter(got)
        np.testing.assert_array_equal(next(it), want.batch_at(0))
        np.testing.assert_array_equal(next(it), want.batch_at(1))


def test_synthetic_rejects_an_uneven_shard_count():
    with pytest.raises(ValueError, match="divide"):
        SyntheticTokens(vocab_size=8, seq_len=4, global_batch=6, n_shards=4)


def test_token_file_batches_are_bit_identical(tmp_path):
    from repro.data import TokenFileDataset as JaxTokenFile

    path = tmp_path / "tokens.bin"
    np.random.default_rng(0).integers(0, 1000, 5000).astype(np.int32).tofile(
        path)
    for shard in (0, 1):
        kw = dict(path=str(path), seq_len=15, global_batch=8, shard=shard,
                  n_shards=2)
        got, want = TokenFileDataset(**kw), JaxTokenFile(**kw)
        assert got.n_steps == want.n_steps == 5000 // (8 * 16)
        for step in (0, 3, got.n_steps, 2 * got.n_steps + 1):
            np.testing.assert_array_equal(got.batch_at(step),
                                          want.batch_at(step))
