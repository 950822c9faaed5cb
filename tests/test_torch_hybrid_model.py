"""The port's hybrid interleave vs the reference ``repro.models.lm`` on
reduced ``jamba-1.5-large-398b``: a period of 8 sub-layers, attention at
index 4 and mamba at the other seven, a 4-expert top-2 MoE on the odd
sub-layers and a dense swiglu on the even ones.  The checks and their
tolerances are ``tests/test_torch_ssm_model.py``'s (its module
docstring); an MoE sub-layer takes the reference's MoE W8A8 bound.  The
decode steps are in ``tests/test_torch_hybrid_decode.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.models import lm
from test_torch_ssm_model import (BACKENDS, build, cfgs, check_dispatches,
                                  check_forward, check_layout)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs several workers on the
    machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jamba():
    return build("jamba")


def test_the_interleave_is_the_reference_period(jamba):
    _, tc = cfgs("jamba")
    assert lm.period(tc) == 8 and lm.n_super(tc) == 1
    kinds = [lm.sublayer_kind(tc, i) for i in range(8)]
    assert [k["mixer"] for k in kinds] == ["mamba"] * 4 + ["attn"] + \
        ["mamba"] * 3
    assert [k["mlp"] for k in kinds] == ["dense", "moe"] * 4
    blocks = jamba[1]["blocks"]
    assert [("attn" in b, "mamba" in b, "moe" in b, "mlp" in b)
            for b in blocks] == [(k["mixer"] == "attn", k["mixer"] == "mamba",
                                  k["mlp"] == "moe", k["mlp"] == "dense")
                                 for k in kinds]
    assert not lm.supports_batched_prefill(tc)
    assert not lm.supports_paged_kv(tc)


@pytest.mark.parametrize("backend", BACKENDS)
def test_forward_and_prefill_match_reference(jamba, backend):
    check_forward("jamba", backend, jamba)


def test_layout_mirrors_reference(jamba):
    check_layout("jamba", jamba)


def test_site_plans_and_dispatches_match_reference(jamba):
    """The attention projections and products, the router, the expert
    banks, the dense MLP and the mamba sites, each once per sub-layer of
    its kind."""
    counts = check_dispatches("jamba", jamba)
    assert counts["mamba.z"] == 7 and counts["attn.wq"] == 1
    assert counts["moe.router"] == 4 and counts["mlp.wo"] == 4
    assert counts["attn.qk"] == counts["attn.pv"] == 1
    assert np.sum(list(counts.values())) == 7 * 4 + 6 + 4 * 4 + 4 * 2 + 1
