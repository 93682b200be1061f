"""The port's checkpoint engine (``repro_torch.storage.checkpoint``)
against the JAX package's, on the CPU.  The on-disk format is one:
checkpoints of the same tree are byte-identical file for file
(``MANIFEST.json`` included), each package restores the other's
bit-equal (bfloat16 included), and the priced stall (``modeled``) equals
the JAX package's.  Round trips, chunking, striping, garbage collection
and elastic channel counts are checked on the port alone."""

import json

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.storage import checkpoint as j_ck
from repro_torch.storage import checkpoint as ck

RAW = {np.dtype(np.float32): np.int32, np.dtype(np.int32): np.int32,
       np.dtype(ml_dtypes.bfloat16): np.uint16, np.dtype(np.int64): np.int64}
TORCH_RAW = {torch.float32: torch.int32, torch.int32: torch.int32,
             torch.bfloat16: torch.int16, torch.int64: torch.int64}


def leaves_np(seed=0, big=False):
    """Seeded numpy leaves: float32, bfloat16 (random bit patterns, NaNs
    and infinities included) and int32, one 0-d, one empty."""
    rng = np.random.default_rng(seed)
    bf = rng.integers(0, 1 << 16, (48, 40), dtype=np.uint16)
    out = {
        "w": rng.standard_normal((64, 32)).astype(np.float32),
        "b": bf.view(ml_dtypes.bfloat16),
        "k0": rng.integers(0, 1 << 16, (8, 4), dtype=np.uint16).view(
            ml_dtypes.bfloat16),
        "k1": rng.standard_normal((8, 4)).astype(np.float32),
        "count": np.asarray(7, np.int32),
        "mu0": rng.standard_normal(5).astype(np.float32),
        "mu1": rng.integers(-9, 9, (3, 3), dtype=np.int32),
        "empty": np.zeros((0, 3), np.float32),
        "steps": rng.integers(0, 100, 7, dtype=np.int32),
    }
    if big:      # past CHUNK_BYTES: 20 MiB of float32 in 2 chunks
        out["big"] = rng.standard_normal(5 << 20).astype(np.float32)
    return out


def tree(leaf, lv):
    """The same nested structure (dicts, lists, tuples, None, keys that
    sort differently as numbers and as strings, a key that needs
    ``_safe``) over converted leaves."""
    t = {"params": {"w": leaf(lv["w"]), "b": leaf(lv["b"]),
                    "layers": [{"k": leaf(lv["k0"])},
                               {"k": leaf(lv["k1"]), "skip": None}],
                    "attn.q-proj": leaf(lv["empty"])},
         "opt": {"count": leaf(lv["count"]),
                 "mu": (leaf(lv["mu0"]), leaf(lv["mu1"]))},
         "by_step": {10: leaf(lv["steps"]), 9: leaf(lv["count"])}}
    if "big" in lv:
        t["big"] = leaf(lv["big"])
    return t


def to_torch(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def assert_bits_np(got: np.ndarray, want: np.ndarray):
    assert got.dtype == want.dtype and got.shape == want.shape
    raw = RAW[want.dtype]
    assert np.array_equal(got.view(raw), want.view(raw))


def assert_bits_torch(got: torch.Tensor, want: torch.Tensor):
    assert got.device.type == "cpu"
    assert got.dtype == want.dtype and got.shape == want.shape
    raw = TORCH_RAW[want.dtype]
    assert torch.equal(got.view(raw), want.view(raw))


def assert_same_structure(got, want):
    assert type(got) is type(want)
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            assert_same_structure(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert_same_structure(g, w)
    elif want is None:
        assert got is None


def tree_files(root):
    return {p.relative_to(root).as_posix(): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def test_flatten_is_the_jax_order():
    nested = {"b": [1, 2], "a": {"z": np.ones(2), "c": (3, 4)}, "n": None,
              10: 5, 9: 6}
    with pytest.raises(TypeError):     # str and int keys do not sort
        ck._flatten(nested)
    nested = {k: v for k, v in nested.items() if isinstance(k, str)}
    assert list(ck._flatten(nested)) == ["a/c/0", "a/c/1", "a/z", "b/0",
                                         "b/1"]
    assert list(ck._flatten(nested)) == list(j_ck._flatten(nested))
    lv = leaves_np()
    assert list(ck._flatten(tree(to_torch, lv))) == \
        list(j_ck._flatten(tree(jnp.asarray, lv)))


@pytest.mark.parametrize("channels,ways", [(1, 1), (3, 2), (4, 4)])
def test_round_trip(tmp_path, channels, ways):
    lv = leaves_np(seed=channels)
    state = tree(to_torch, lv)
    eng = ck.CheckpointEngine(tmp_path, channels=channels, ways=ways,
                              device="cpu")
    eng.save(10, state, extra={"pipe_cursor": 7}, blocking=True)
    step, restored, extra = eng.restore(template=state)
    assert step == 10 and extra == {"pipe_cursor": 7}
    assert_same_structure(restored, state)
    flat_got, flat_want = ck._flatten(restored), ck._flatten(state)
    assert list(flat_got) == list(flat_want)
    for k in flat_want:
        assert_bits_torch(flat_got[k], flat_want[k])
    step, flat, _ = eng.restore()
    assert list(flat) == list(flat_want)


def test_jax_writes_port_restores(tmp_path):
    lv = leaves_np(seed=3, big=True)
    j_ck.CheckpointEngine(tmp_path, channels=3, ways=2).save(
        4, tree(jnp.asarray, lv), extra={"cursor": 12}, blocking=True)
    state = tree(to_torch, lv)
    step, restored, extra = ck.CheckpointEngine(
        tmp_path, channels=3, device="cpu").restore(template=state)
    assert (step, extra) == (4, {"cursor": 12})
    assert_same_structure(restored, state)
    want = ck._flatten(state)
    for k, v in ck._flatten(restored).items():
        assert_bits_torch(v, want[k])


def test_port_writes_jax_restores(tmp_path):
    lv = leaves_np(seed=4, big=True)
    ck.CheckpointEngine(tmp_path, channels=3, ways=2, device="cpu").save(
        5, tree(to_torch, lv), extra={"cursor": 1}, blocking=True)
    template = tree(jnp.asarray, lv)
    step, restored, extra = j_ck.CheckpointEngine(
        tmp_path, channels=3).restore(template=template)
    assert (step, extra) == (5, {"cursor": 1})
    want = j_ck._flatten(tree(lambda a: a, lv))
    got = j_ck._flatten(restored)
    assert list(got) == list(want)
    for k in want:
        assert_bits_np(np.asarray(got[k]), want[k])


@pytest.mark.parametrize("channels,ways,big", [(1, 1, False), (3, 2, True),
                                               (4, 4, False)])
def test_checkpoints_are_byte_identical_and_priced_alike(tmp_path, channels,
                                                         ways, big):
    lv = leaves_np(seed=channels, big=big)
    j_eng = j_ck.CheckpointEngine(tmp_path / "jax", channels=channels,
                                  ways=ways)
    p_eng = ck.CheckpointEngine(tmp_path / "port", channels=channels,
                                ways=ways, device="cpu")
    j_eng.save(3, tree(jnp.asarray, lv), extra={"cursor": 9}, blocking=True)
    p_eng.save(3, tree(to_torch, lv), extra={"cursor": 9}, blocking=True)
    want = tree_files(tmp_path / "jax")
    got = tree_files(tmp_path / "port")
    assert list(got) == list(want)
    for name in want:
        assert got[name] == want[name], name
    manifest = json.loads(got["step_00000003/MANIFEST.json"])
    assert manifest["leaves"]["params/b"]["dtype"] == "bfloat16"
    j_res, p_res = j_eng.wait(), p_eng.wait()
    assert (p_res.step, p_res.nbytes) == (j_res.step, j_res.nbytes)
    assert p_res.modeled == j_res.modeled
    assert p_res.modeled["proposed"] < p_res.modeled["sync_only"] \
        <= p_res.modeled["conv"]


def test_stall_is_priced_once_per_size(tmp_path):
    from repro_torch.storage import ssd_model
    eng = ck.CheckpointEngine(tmp_path, channels=2, keep=4, device="cpu")
    small = {"x": torch.zeros(1000)}
    ck._stall_seconds.cache_clear()
    ssd_model.reset_estimates()
    eng.save(1, small, blocking=True)
    first = eng.wait()
    assert ssd_model.ESTIMATES["calls"] == 3        # one per interface
    eng.save(2, {"y": torch.ones(1000)}, blocking=True)   # same bytes
    second = eng.wait()
    assert ssd_model.ESTIMATES["calls"] == 3
    assert second.step == 2 and second.modeled == first.modeled
    assert second.modeled is not first.modeled
    eng.save(3, {"x": torch.zeros(2000)}, blocking=True)  # another size
    assert ssd_model.ESTIMATES["calls"] == 6
    assert eng.wait().modeled["conv"] > first.modeled["conv"]
    assert not eng.writing()


def test_bf16_file_layout(tmp_path):
    bits = np.array([0x3F80, 0xFFC1, 0x0001, 0x7F80], np.uint16)
    ck.CheckpointEngine(tmp_path, channels=1, device="cpu").save(
        1, {"x": torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16)},
        blocking=True)
    raw = (tmp_path / "step_00000001" / "ch0" / "x__c0.npy").read_bytes()
    assert b"'descr': '<V2'" in raw and raw.endswith(bits.tobytes())
    arr = np.load(tmp_path / "step_00000001" / "ch0" / "x__c0.npy")
    assert arr.dtype == np.dtype("V2")
    assert np.array_equal(arr.view(np.uint16), bits)


def test_chunking_and_striping(tmp_path, monkeypatch):
    monkeypatch.setattr(ck, "CHUNK_BYTES", 1024)
    state = {"a": torch.arange(1000, dtype=torch.float32),       # 4 chunks
             "b": torch.arange(10, dtype=torch.int32),           # 1 chunk
             "c": torch.ones(513, dtype=torch.bfloat16)}         # 2 chunks
    eng = ck.CheckpointEngine(tmp_path, channels=3, device="cpu")
    eng.save(2, state, blocking=True)
    src = tmp_path / "step_00000002"
    manifest = json.loads((src / "MANIFEST.json").read_text())
    assert [m["chunks"] for m in manifest["leaves"].values()] == [4, 1, 2]
    names = [f"a__c{j}" for j in range(4)] + ["b__c0", "c__c0", "c__c1"]
    for i, name in enumerate(names):        # chunk i lands on channel i % 3
        assert (src / f"ch{i % 3}" / f"{name}.npy").exists(), name
    assert eng.wait().nbytes == 4000 + 40 + 1026
    # a job with another channel count finds every chunk
    for channels in (1, 2, 5):
        _, got, _ = ck.CheckpointEngine(tmp_path, channels=channels,
                                        device="cpu").restore(template=state)
        for k in state:
            assert torch.equal(got[k].view(TORCH_RAW[state[k].dtype]),
                               state[k].view(TORCH_RAW[state[k].dtype]))


def test_gc_latest_and_missing(tmp_path):
    eng = ck.CheckpointEngine(tmp_path, keep=2, device="cpu")
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        eng.restore()
    assert eng.latest_step() is None and eng.wait() is None
    st = {"x": torch.zeros(4)}
    for step in (1, 2, 3):
        eng.save(step, st, blocking=True)
        assert eng.wait().step == step
    assert eng.latest_step() == 3
    assert sorted(p.name for p in tmp_path.glob("step_*")) == \
        ["step_00000002", "step_00000003"]
    assert eng.restore(step=2)[0] == 2


def test_save_snapshots_before_it_returns(tmp_path):
    x = torch.arange(6, dtype=torch.float32)
    n = np.arange(6, dtype=np.int32)
    eng = ck.CheckpointEngine(tmp_path, device="cpu")
    eng.save(1, {"x": x, "n": n})
    x.add_(100.0)            # updated in place while the write may run
    n += 100
    res = eng.wait()
    assert res.step == 1
    _, got, _ = eng.restore()
    assert torch.equal(got["x"], torch.arange(6, dtype=torch.float32))
    assert torch.equal(got["n"], torch.arange(6, dtype=torch.int32))


def test_place_on_device():
    state = {"a": [torch.ones(2), None, (torch.zeros(1, dtype=torch.int32),)],
             "n": np.ones(3, np.float32)}
    placed = ck.place_on_device(state, "cpu")
    assert placed["a"][1] is None and isinstance(placed["a"][2], tuple)
    assert placed["a"][0].device.type == "cpu"
    assert torch.equal(placed["n"], torch.ones(3))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ck.place_on_device(state)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ck.CheckpointEngine("unused-dir-never-made")
