"""The port's config registry against the reference's: all ten
architectures in the reference's order, each ``ModelConfig`` equal field
by field (the fields both packages declare: the port leaves out the
reference's Pallas interpret switch and its mesh and pipeline fields,
which it does not run), ``reduced()`` of each equal too, the same
``param_count``, the same shape cells and live cells, and the same
planner site registry; ``lm.check_supported`` accepts every registered
arch, and ``init_cache`` lays out the reference's cache for each.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
from repro.core import planner as ref_planner
from repro.models import lm as ref_lm
from repro_torch import configs
from repro_torch.core import planner
from repro_torch.models import convert, lm

ARCHS = list(ref_configs.ARCHS)


def _fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def _same(port, ref):
    got, want = _fields(port), _fields(ref)
    assert set(got) <= set(want)
    for name, value in got.items():
        if dataclasses.is_dataclass(value):
            assert _fields(value) == _fields(want[name]), name
        else:
            assert value == want[name], name


def test_every_reference_arch_is_registered_in_its_order():
    assert list(configs.ARCHS) == ARCHS
    assert len(ARCHS) == 10
    assert configs.LONG_CONTEXT_ARCHS == ref_configs.LONG_CONTEXT_ARCHS


@pytest.mark.parametrize("arch", ARCHS)
def test_config_equals_the_reference(arch):
    port, ref = configs.get_config(arch), ref_configs.get_config(arch)
    _same(port, ref)
    _same(configs.reduced(port), ref_configs.reduced(ref))
    _same(configs.reduced(port, d_ff=0), ref_configs.reduced(ref, d_ff=0))
    for active in (False, True):
        assert port.param_count(active) == ref.param_count(active)
    assert port.n_layers % lm.period(port) == 0
    assert port.padded_vocab == ref.padded_vocab


def test_shapes_and_cells_equal_the_reference():
    for name in configs.SHAPES:
        assert _fields(configs.get_shape(name)) == \
            _fields(ref_configs.get_shape(name))
    assert configs.all_cells() == ref_configs.all_cells()
    for arch in ARCHS:
        for shape in configs.SHAPES:
            assert configs.cell_is_runnable(arch, shape) == \
                ref_configs.cell_is_runnable(arch, shape)
    with pytest.raises(KeyError, match="unknown shape"):
        configs.get_shape("nope")
    with pytest.raises(KeyError, match="unknown arch"):
        configs.get_config("nope")


def test_site_registry_equals_the_reference():
    planner.site_registry.cache_clear()
    assert planner.site_registry() == ref_planner.site_registry()
    assert {"mamba.z", "mamba.xbc", "mamba.dt", "mamba.out", "xattn.kv",
            "moe.router"} <= planner.site_registry()


def _leaf_shapes(cache):
    return [{k: (tuple(t.shape), str(t.dtype).split(".")[-1])
             for k, t in c.items()} for c in cache]


@pytest.mark.parametrize("arch", ARCHS)
def test_check_supported_gates_what_is_not_ported(arch):
    """Every registered arch runs: ``check_supported`` passes, and the
    reduced config's ``init_cache`` has the reference's leaves (K/V
    rings, recurrent state, cross ``xk`` / ``xv``) and shapes."""
    cfg = configs.get_config(arch)
    lm.check_supported(cfg)
    lm.check_supported(configs.reduced(cfg))
    rc = ref_configs.reduced(ref_configs.get_config(arch))
    got = lm.init_cache(configs.reduced(cfg), 1, 8, device="cpu")
    assert _leaf_shapes(got) == _leaf_shapes(ref_lm.init_cache(rc, 1, 8))
    with pytest.raises(NotImplementedError, match="unknown model family"):
        lm.check_supported(dataclasses.replace(cfg, family="nope"))


@pytest.mark.parametrize("arch", ["llama3-8b", "qwen2.5-14b", "stablelm-12b"])
def test_extra_dense_archs_decode_like_the_reference(arch):
    """The three dense archs beyond qwen2-0.5b are data on the dense path:
    reduced, fp32, converted weights, two decode steps on ``arrayflex``
    within 1e-4 of the reference's logits."""
    kw = dict(gemm_backend="arrayflex", compute_dtype="float32")
    rc = dataclasses.replace(ref_configs.reduced(ref_configs.ARCHS[arch]),
                             **kw)
    tc = dataclasses.replace(configs.reduced(configs.get_config(arch)), **kw)
    rp = ref_lm.init_params(rc, jax.random.PRNGKey(0))
    tp = convert.params_from_reference(
        tc, jax.tree_util.tree_map(np.asarray, rp), device="cpu")
    rcache = ref_lm.init_cache(rc, 2, 8, dtype=jnp.float32)
    tcache = lm.init_cache(tc, 2, 8, dtype=torch.float32, device="cpu")
    toks = [3, 5]
    for step in range(2):
        rl, rcache = ref_lm.decode_step(rc, rp, rcache, jnp.asarray(toks),
                                        jnp.asarray([step, step]))
        tl, tcache = lm.decode_step(tc, tp, tcache, torch.tensor(toks),
                                    torch.tensor([step, step]))
        np.testing.assert_allclose(tl.numpy(), np.asarray(rl), rtol=0,
                                   atol=1e-4)
        toks = [int(t) for t in np.argmax(np.asarray(rl), -1)]
