"""The port's ten architecture configs against the JAX package's: each
``CONFIG`` / ``SMOKE`` / ``ARCH`` reads the same, and each full-size and
SMOKE model's parameters have JAX's key paths, shapes and dtypes leaf for
leaf (the port's init on the meta device, JAX's under
``jax.eval_shape``: no weight is drawn), hence the same count."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import registry as j_registry
from repro.models import transformer as j_tf
from repro_torch.configs import registry
from repro_torch.models import transformer

ARCH_IDS = j_registry.ARCH_IDS
# total parameters of the full configs, from their published sizes
PUBLISHED_B = {"qwen2-0.5b": (0.45, 0.55), "minicpm-2b": (2.5, 3.1),
               "granite-3-2b": (2.4, 2.7), "starcoder2-3b": (3.0, 3.3),
               "llama4-maverick-400b-a17b": (380.0, 420.0),
               "granite-moe-3b-a800m": (3.2, 3.5),
               "musicgen-medium": (1.3, 1.6), "recurrentgemma-9b": (8.4, 8.8),
               "qwen2-vl-2b": (1.4, 1.8), "xlstm-350m": (0.3, 0.5)}


def test_registry_lists_the_same_ids():
    assert registry.ARCH_IDS == ARCH_IDS
    assert set(registry.all_arches()) == set(ARCH_IDS)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_arch_reads_as_the_jax_one(arch):
    got, want = registry.get_arch(arch), j_registry.get_arch(arch)
    for name in ("config", "smoke"):
        assert dataclasses.asdict(getattr(got, name)) == \
            dataclasses.asdict(getattr(want, name)), name
    assert got.source == want.source and got.notes == want.notes
    assert [dataclasses.asdict(s) for s in got.shapes] == \
        [dataclasses.asdict(s) for s in want.shapes]
    for name in ("config", "smoke"):
        g, w = getattr(got, name), getattr(want, name)
        assert (g.num_units, g.padded_vocab, g.hd) == \
            (w.num_units, w.padded_vocab, w.hd)
        for sub in ("moe", "rglru", "mlstm", "slstm"):
            assert (getattr(g, sub) is None) == (getattr(w, sub) is None)
            if getattr(g, sub) is not None:
                assert type(getattr(g, sub)).__module__.startswith(
                    "repro_torch.models.")


def meta_params(cfg, monkeypatch):
    monkeypatch.setattr(transformer, "resolve_device",
                        lambda device=None: torch.device("meta"))
    return transformer.init_params(cfg, torch.Generator().manual_seed(0))


def leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def shapes_equal(cfg, jcfg, monkeypatch) -> int:
    tp = meta_params(cfg, monkeypatch)
    jp = jax.eval_shape(lambda: j_tf.init_params(jcfg,
                                                 jax.random.PRNGKey(0)))
    got = [(path, tuple(x.shape), str(x.dtype).split(".")[-1])
           for path, x in leaves(tp)]
    want = [(path, tuple(x.shape), str(x.dtype))
            for path, x in leaves(jax.tree.map(lambda a: a, jp))]
    assert got == want
    assert transformer.param_count(tp) == sum(
        int(np.prod(s)) for _, s, _ in want)
    return transformer.param_count(tp)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_full_config_parameters_leaf_for_leaf(arch, monkeypatch):
    got, want = registry.get_arch(arch), j_registry.get_arch(arch)
    n = shapes_equal(got.config, want.config, monkeypatch)
    lo, hi = PUBLISHED_B[arch]
    assert lo * 1e9 <= n <= hi * 1e9, n


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_smoke_config_parameters_leaf_for_leaf(arch, monkeypatch):
    got, want = registry.get_arch(arch), j_registry.get_arch(arch)
    shapes_equal(got.smoke, want.smoke, monkeypatch)
