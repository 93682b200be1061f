"""The port's token pipeline (``repro_torch.storage.datapipe``) against
the JAX package's, on the CPU: the checks of ``tests/test_storage.py`` on
the port, batches equal to the JAX package's ``SyntheticTokens`` /
``FileBackedTokens`` on the same seeds and the same store (CPU
``torch.int32`` tensors against its numpy arrays, values and dtype), and
``pipeline_io_requests`` / ``pipeline_io_trace`` array-equal to JAX's,
hedged reads included."""

import numpy as np
import pytest
import torch

from repro.core.sim import SSDConfig as JConfig
from repro.storage import datapipe as j_dp
from repro_torch.core.sim import SSDConfig
from repro_torch.storage import datapipe as dp
from repro_torch.storage.ssd_model import estimate_trace

STREAM_FIELDS = ("arrival_us", "op_cls", "n_pages", "stream", "payload",
                 "hedge_of", "lpn")
TRACE_FIELDS = ("cls", "channel", "way", "parity", "payload", "arrival_us",
                "extra_us")


def take(pipe, n):
    it = iter(pipe)
    try:
        return [next(it) for _ in range(n)]
    finally:
        if hasattr(pipe, "close"):
            pipe.close()


def assert_same_batch(got, want):
    assert set(got) == {"inputs", "labels"}
    for k in ("inputs", "labels"):
        assert isinstance(got[k], torch.Tensor)
        assert got[k].device.type == "cpu" and got[k].dtype == torch.int32
        assert want[k].dtype == np.int32
        assert np.array_equal(got[k].numpy(), want[k])


def same_array(a, b) -> bool:
    if a is None or b is None:
        return a is None and b is None
    return a.dtype == b.dtype and np.array_equal(a, b)


@pytest.fixture
def store_dir(tmp_path):
    rng = np.random.default_rng(0)
    dp.StripedTokenStore.write(tmp_path,
                               rng.integers(0, 5000, 40_000, dtype=np.int32),
                               channels=4)
    return tmp_path


# -- the checks of tests/test_storage.py, on the port ---------------------

def test_synthetic_pipeline_deterministic_resume():
    a = dp.SyntheticTokens(1000, batch=2, seq=8, seed=1)
    it = iter(a)
    for _ in range(5):
        next(it)
    st = a.state()
    more = [next(it) for _ in range(2)]
    b = dp.SyntheticTokens(1000, batch=2, seq=8, seed=1)
    b.restore(st)
    it2 = iter(b)
    for expected in more:
        assert torch.equal(expected["inputs"], next(it2)["inputs"])


def test_file_backed_pipeline(store_dir):
    store = dp.StripedTokenStore(store_dir)
    pipe = dp.FileBackedTokens(store, batch=4, seq=16, ways=2)
    (b1,) = take(pipe, 1)
    assert b1["inputs"].shape == (4, 16)
    assert torch.equal(b1["inputs"][:, 1:], b1["labels"][:, :-1])


def test_pipeline_emits_priceable_trace(tmp_path):
    rng = np.random.default_rng(0)
    store = dp.StripedTokenStore.write(
        tmp_path, rng.integers(0, 5000, 40_000, dtype=np.int32), channels=2)
    pipe = dp.FileBackedTokens(store, batch=4, seq=16, ways=2)
    take(pipe, 1)
    tr = dp.pipeline_io_trace(pipe, n_batches=64)
    assert tr is not None and tr.channels == 2
    est = estimate_trace(tr, SSDConfig(channels=2, ways=2),
                         total_bytes=64 * 4 * 17 * 4, device="cpu")
    assert est.seconds > 0 and est.write_bytes == 0 and est.read_bytes > 0
    assert dp.pipeline_io_trace(dp.SyntheticTokens(10, 1, 8), 4) is None
    assert dp.pipeline_io_requests(dp.SyntheticTokens(10, 1, 8), 4) is None


# -- against the JAX package ------------------------------------------------

@pytest.mark.parametrize("vocab,batch,seq,seed", [
    (1000, 2, 8, 1), (32000, 3, 17, 0), (7, 1, 1, 123)])
def test_synthetic_batches_equal_jax(vocab, batch, seq, seed):
    got = dp.SyntheticTokens(vocab, batch, seq, seed=seed)
    want = j_dp.SyntheticTokens(vocab, batch, seq, seed=seed)
    for g, w in zip(take(got, 4), take(want, 4)):
        assert_same_batch(g, w)
    assert got.state() == dp.PipeState(4) and want.state().cursor == 4
    got.restore(dp.PipeState(11))
    want.restore(j_dp.PipeState(11))
    assert_same_batch(next(iter(got)), next(iter(want)))


@pytest.mark.parametrize("batch,seq,ways,hedge_ms", [
    (4, 16, 2, 50.0), (3, 255, 4, 50.0), (5, 31, 1, -1.0)])
def test_file_backed_batches_equal_jax_and_numpy(store_dir, batch, seq, ways,
                                                 hedge_ms):
    """On the same store and cursor, the port's batches equal JAX's and
    plain numpy reads at the pipeline's offsets.  ``hedge_ms=-1`` hedges
    every read, so the replica path is taken deterministically."""
    store = dp.StripedTokenStore(store_dir)
    got = take(dp.FileBackedTokens(store, batch, seq, ways=ways,
                                   hedge_ms=hedge_ms), 6)
    want = take(j_dp.FileBackedTokens(j_dp.StripedTokenStore(store_dir),
                                      batch, seq, ways=ways,
                                      hedge_ms=hedge_ms), 6)
    shards = [np.load(p) for p in sorted(store_dir.glob("shard_*.npy"))]
    hedge = 1 if hedge_ms < 0 else 0
    for idx, (g, w) in enumerate(zip(got, want)):
        assert_same_batch(g, w)
        rows = []
        for b in range(batch):
            gi = idx * batch + b
            m = shards[(gi % len(shards) + hedge) % len(shards)]
            off = (gi // len(shards)) * (seq + 1) % max(1, len(m) - seq - 1)
            rows.append(m[off:off + seq + 1])
        assert np.array_equal(g["inputs"].numpy(), np.stack(rows)[:, :-1])


def test_file_backed_resume(store_dir):
    store = dp.StripedTokenStore(store_dir)
    first = dp.FileBackedTokens(store, batch=3, seq=20, ways=2)
    run = take(first, 5)
    st = first.state()
    assert st == dp.PipeState(5)
    again = dp.FileBackedTokens(store, batch=3, seq=20, ways=2)
    again.restore(dp.PipeState(3))
    for g, w in zip(take(again, 2), run[3:]):
        assert torch.equal(g["inputs"], w["inputs"])
        assert torch.equal(g["labels"], w["labels"])


@pytest.mark.parametrize("hedge_ms,consumed,n_batches", [
    (50.0, 1, 64), (-1.0, 3, 64), (-1.0, 2, 1000)])
def test_pipeline_io_requests_and_trace_equal_jax(store_dir, hedge_ms,
                                                  consumed, n_batches):
    store = dp.StripedTokenStore(store_dir)
    pipe = dp.FileBackedTokens(store, batch=4, seq=16, ways=2,
                               hedge_ms=hedge_ms)
    jpipe = j_dp.FileBackedTokens(j_dp.StripedTokenStore(store_dir), batch=4,
                                  seq=16, ways=2, hedge_ms=hedge_ms)
    take(pipe, consumed)
    take(jpipe, consumed)
    # the producer may prefetch past the consumer: the hedge rate is the
    # pipe's observed one, the same count given to both
    pipe.hedged_reads = jpipe.hedged_reads = (
        0 if hedge_ms > 0 else consumed * 4)
    for ssd, jssd in ((None, None), (SSDConfig(channels=2, ways=8),
                                     JConfig(channels=2, ways=8))):
        req = dp.pipeline_io_requests(pipe, n_batches, ssd)
        jreq = j_dp.pipeline_io_requests(jpipe, n_batches, jssd)
        for f in STREAM_FIELDS:
            assert same_array(getattr(req, f), getattr(jreq, f)), f
        tr = dp.pipeline_io_trace(pipe, n_batches, ssd)
        jtr = j_dp.pipeline_io_trace(jpipe, n_batches, jssd)
        assert (tr.channels, tr.ways) == (jtr.channels, jtr.ways)
        for f in TRACE_FIELDS:
            assert same_array(getattr(tr, f), getattr(jtr, f)), f
    if hedge_ms < 0:
        assert not req.payload.all()


def test_pipe_ssd_caps_channels(tmp_path):
    rng = np.random.default_rng(1)
    store = dp.StripedTokenStore.write(
        tmp_path, rng.integers(0, 9, 12_000, dtype=np.int32), channels=12)
    pipe = dp.FileBackedTokens(store, batch=2, seq=8, ways=4)
    assert dp._pipe_ssd(pipe, None) == SSDConfig(channels=8, ways=4)
    assert store.tokens_per_shard == 1000 and len(store.shards) == 12
    with pytest.raises(FileNotFoundError, match="shard_"):
        dp.StripedTokenStore(tmp_path / "empty")
