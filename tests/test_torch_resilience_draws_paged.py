"""The port's ``substrate.dispatch`` draws against the reference's on the
paged engine: ``gemm_fault_at = n`` for every n from 0 to one past the
reference's draws in its first paged prefill and decode traces, as
``tests/test_torch_resilience_draws.py`` does on the dense engine."""
import pytest
import torch

from test_torch_resilience_draws import QWEN_DRAWS, check_gemm_fault_at
from test_torch_resilience_parity import models


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs several workers on the
    machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def qwen():
    return models(backend="xla")


@pytest.mark.parametrize("n", range(QWEN_DRAWS + 1))
def test_paged_gemm_fault_at_matches_reference(qwen, n):
    check_gemm_fault_at(qwen, n, kv_pages=40, page_size=8)
