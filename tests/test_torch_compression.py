"""The port's data-parallel gradient sync (``distributed.compression``'s
``make_dp_grad_sync`` / ``compressed_psum``) over two gloo ranks, against
the JAX package's ``compressed_psum`` and ``psum`` mean under
``jax.vmap(axis_name=)`` on the same seeded numpy gradients: bit-equal,
compressed and not.  The ranks are spawned processes meeting on a
``FileStore``; each writes its result to a file.  The gradient trees hold
an all-zero leaf and a leaf whose absmax is under 1e-20 (the scale's
floor)."""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

with warnings.catch_warnings():   # its jax.experimental.shard_map import
    warnings.simplefilter("ignore", DeprecationWarning)
    from repro.distributed import compression as j_compression

from repro_torch.distributed.compression import (compressed_psum,
                                                  make_dp_grad_sync)
from repro_torch.train.optimizer import tree_paths

RANKS = 2
SHAPES = {"a": (5, 7), "b": (33,), "nested/c": (2, 3, 4), "nested/d": ()}


def grads(rank: int, case: str) -> dict[str, np.ndarray]:
    """Rank ``rank``'s partial gradients, flat by path."""
    rng = np.random.default_rng(100 * rank + 7)
    out = {}
    for path, shape in SHAPES.items():
        g = rng.standard_normal(shape)
        if case == "wide":
            g = g * 10.0 ** rng.integers(-6, 4, shape)
        out[path] = np.asarray(g, np.float32)
    if case == "zeros":
        out["b"] = np.zeros(SHAPES["b"], np.float32)
    if case == "tiny":           # absmax under 1e-20 on every rank
        out["b"] = (out["b"] * np.float32(3e-22)).astype(np.float32)
        out["nested/c"] = np.zeros(SHAPES["nested/c"], np.float32)
        out["nested/c"][0, 0, 0] = np.float32(1e-21 * (rank + 1))
    return out


def nest(flat: dict) -> dict:
    tree: dict = {}
    for path, v in flat.items():
        node = tree
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return tree


def _rank(rank: int, store_path: str, case: str, out_dir: str) -> None:
    store = dist.FileStore(store_path, RANKS)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=RANKS)
    try:
        tree = nest({k: torch.from_numpy(v)
                     for k, v in grads(rank, case).items()})
        out = {}
        for compress in (True, False):
            synced = make_dp_grad_sync(compress=compress)(tree)
            for path, x in tree_paths(synced):
                out[f"{compress}/{'/'.join(path)}"] = x.numpy()
        for path, x in tree_paths(compressed_psum(tree)):
            out[f"sum/{'/'.join(path)}"] = x.numpy()
        np.savez(f"{out_dir}/rank{rank}.npz", **out)
    finally:
        dist.destroy_process_group()


def jax_sync(case: str) -> dict[str, np.ndarray]:
    """The JAX package's sync body (``make_dp_grad_sync``'s ``sync``,
    with its ``compressed_psum``) under ``jax.vmap`` over the ranks."""
    stacked = nest({k: jnp.stack([grads(r, case)[k] for r in range(RANKS)])
                    for k in SHAPES})

    def sync(g, compress):
        n = jax.lax.psum(jnp.ones(()), "i")
        summed = (j_compression.compressed_psum(g, "i") if compress else
                  jax.tree.map(lambda x: jax.lax.psum(x, "i"), g))
        return jax.tree.map(lambda x: x / n, summed)

    out = {}
    for compress in (True, False):
        res = jax.vmap(lambda g: sync(g, compress), axis_name="i")(stacked)
        for path in SHAPES:
            leaf = res
            for k in path.split("/"):
                leaf = leaf[k]
            out[f"{compress}/{path}"] = np.asarray(leaf)
    res = jax.vmap(lambda g: j_compression.compressed_psum(g, "i"),
                   axis_name="i")(stacked)
    for path in SHAPES:
        leaf = res
        for k in path.split("/"):
            leaf = leaf[k]
        out[f"sum/{path}"] = np.asarray(leaf)
    return out


@pytest.mark.parametrize("case", ("normal", "wide", "zeros", "tiny"))
def test_dp_grad_sync_bit_equal_to_jax(case, tmp_path):
    mp.start_processes(_rank, args=(str(tmp_path / "store"), case,
                                    str(tmp_path)),
                       nprocs=RANKS, join=True, start_method="spawn")
    want = jax_sync(case)
    for rank in range(RANKS):
        got = dict(np.load(tmp_path / f"rank{rank}.npz"))
        assert sorted(got) == sorted(want)
        for key, w in want.items():
            # every rank holds the same result: JAX's row for it
            assert got[key].dtype == w[rank].dtype, key
            np.testing.assert_array_equal(got[key], w[rank], err_msg=key)
    if case == "zeros":
        assert not np.any(want["True/b"])
    if case == "tiny":           # the scale is the floor's 1e-20 / 127
        step = np.float32(1e-20) / np.float32(127.0)
        q = want["sum/b"][0] / step
        np.testing.assert_allclose(q, np.round(q), rtol=1e-6)
        assert np.any(q)


def test_sync_needs_a_process_group():
    assert not dist.is_initialized()
    with pytest.raises((RuntimeError, ValueError)):
        make_dp_grad_sync()({"a": torch.ones(3)})
