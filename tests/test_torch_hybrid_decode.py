"""Twelve decode steps of the port's hybrid interleave (reduced
``jamba-1.5-large-398b``) against the reference's, the conv window cached
in fp32 on every backend and in bf16 on ``xla`` and ``arrayflex``:
``tests/test_torch_ssm_model.py``'s ``check_decode``, cases and
tolerances (its module docstring).
"""
import pytest
import torch

from test_torch_ssm_model import DECODE_CASES, build, check_decode


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


@pytest.mark.parametrize("backend,conv_dtype", DECODE_CASES)
def test_decode_steps_match_reference(jamba, backend, conv_dtype):
    check_decode("jamba", backend, jamba, conv_dtype)
