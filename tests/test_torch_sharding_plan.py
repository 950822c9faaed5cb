"""The port's sharding plan names (``repro_torch.parallel.sharding``)
against the reference's ``parallel/sharding.py``.

``core.planner._postshard`` and the role-mesh branch of
``core.planner.model_gemms`` import these names; each comparison is exact
(integer plans, no tolerance).
"""
import dataclasses

import pytest

from repro.configs import get_config as ref_get_config
from repro.configs.base import ShapeConfig as RefShape
from repro.core import planner as ref_planner
from repro.parallel import sharding as ref_sharding
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import planner
from repro_torch.parallel import sharding

ARCHS = ["qwen2-0.5b", "qwen3-moe-30b-a3b"]
# (name, seq_len, global_batch, kind): a serving decode step and a prefill
SHAPES = [("decode", 256, 4, "decode"), ("prefill", 2048, 2, "prefill")]
MESH = [1, 2, 4, 8]


def _fields(gemms):
    return [dataclasses.asdict(g) for g in gemms]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: s[0])
@pytest.mark.parametrize("dp", MESH)
@pytest.mark.parametrize("tp", MESH)
def test_postshard_matches_reference(arch, shape, dp, tp):
    """Every GEMM of ``model_gemms`` after ``_postshard`` at (dp, tp) is
    the reference's, field by field."""
    cfg, ref_cfg = get_config(arch), ref_get_config(arch)
    gemms = planner.model_gemms(cfg, ShapeConfig(*shape))
    ref_gemms = ref_planner.model_gemms(ref_cfg, RefShape(*shape))
    assert _fields(gemms) == _fields(ref_gemms)
    E = cfg.moe.num_experts if cfg.moe else 0
    qk_batch = shape[2] * cfg.n_kv_heads
    got = [planner._postshard(g, dp, tp, E, qk_batch) for g in gemms]
    want = [ref_planner._postshard(g, dp, tp, E, qk_batch)
            for g in ref_gemms]
    assert _fields(got) == _fields(want)


def test_site_sets_match_reference():
    assert sharding._COL_SITES == ref_sharding._COL_SITES
    assert sharding._ROW_SITES == ref_sharding._ROW_SITES
    assert sharding.PP_BOUNDARY_SITE == ref_sharding.PP_BOUNDARY_SITE


def test_batched_shard_count_matches_reference():
    for batch in range(1, 65):
        for dp in range(1, 9):
            for tp in range(1, 9):
                assert sharding.batched_shard_count(batch, dp, tp) == \
                    ref_sharding.batched_shard_count(batch, dp, tp), \
                    (batch, dp, tp)


@pytest.mark.parametrize("role", ["prefill", "decode", ""])
def test_pp_transfer_terms_match_reference(role):
    for pp in range(1, 9):
        for rows, K in ((1, 896), (4, 2048), (37, 4864), (2048, 896)):
            assert sharding.pp_transfer_terms(role, pp, rows, K) == \
                ref_sharding.pp_transfer_terms(role, pp, rows, K), \
                (role, pp, rows, K)


def test_pp_transfer_terms_refuse_an_unknown_role():
    with pytest.raises(ValueError, match="unknown pp_role"):
        sharding.pp_transfer_terms("train", 2, 4, 896)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh,role", [((2, 2), ""), ((1, 4), ""),
                                       ((2, 1, 2), "prefill"),
                                       ((4, 2, 1), "decode"),
                                       ((8, 1, 1), "decode")])
def test_meshed_model_gemms_match_reference(arch, mesh, role):
    """The mesh branches of ``model_gemms`` (2-axis (data, model) and the
    3-axis role mesh, whose pipeline boundary site takes the role's
    transfer terms) import the port's sharding module and give the
    reference's table."""
    shape = ("decode", 256, 4, "decode")
    meshed = dict(mesh_shape=mesh, pp_role=role,
                  pp_stages=mesh[0] if role else 0)
    ref_cfg = dataclasses.replace(ref_get_config(arch), **meshed)
    got = planner.model_gemms(dataclasses.replace(get_config(arch), **meshed),
                              ShapeConfig(*shape))
    want = ref_planner.model_gemms(ref_cfg, RefShape(*shape))
    assert _fields(got) == _fields(want)
    if role:
        wq = [g for g in got if g.name == sharding.PP_BOUNDARY_SITE]
        assert wq and (wq[0].transfer_ops or wq[0].transfer_cycles)
