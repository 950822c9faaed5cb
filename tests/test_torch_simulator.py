"""The port's ``core/simulator.py`` (torch integer and bitwise ops) and
``core/cnn_shapes.py`` against the reference's, with equal values.

The reference's ``tests/test_simulator.py`` and
``tests/test_core_power_shapes.py`` cases on the port, each also run
through the reference on the same inputs: int-mode tiles and tiled
matmuls bit for bit (and equal to ``A @ B``; the hypothesis property
over 25 random ragged shapes against ``A @ B`` alone, as the
reference's own property test holds the reference), cycle counts equal
(Eq. 3 / 4), float tiles equal to the reference's within fp32
summation order (1e-6 of the largest |value|), the CSA compressor, the
occupancy trace, and the CNN GEMM shapes and the planner's savings over
them.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core import cnn_shapes as ref_shapes
from repro.core import planner as ref_planner
from repro.core import simulator as ref_sim
from repro_torch.core import cnn_shapes, planner, power, simulator, timing


def _int_pair(rng, a, b, lo=-128, hi=127):
    A = rng.randint(lo, hi, a).astype(np.int32)
    B = rng.randint(lo, hi, b).astype(np.int32)
    return A, B


@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("shape", [(4, 8, 8), (10, 16, 24), (7, 32, 16)])
def test_tile_int_csa_exact(k, shape):
    T, R, C = shape
    A, B = _int_pair(np.random.RandomState(42), (T, R), (R, C))
    X, cyc = simulator.simulate_tile(torch.tensor(A), torch.tensor(B), k)
    RX, rcyc = ref_sim.simulate_tile(jnp.asarray(A), jnp.asarray(B), k)
    assert X.dtype == torch.int32
    np.testing.assert_array_equal(X.numpy(), np.asarray(RX))
    np.testing.assert_array_equal(X.numpy(), A @ B)
    assert cyc == rcyc == timing.latency_cycles(R, C, T, k)


@pytest.mark.parametrize("k", [1, 2])
def test_tile_float(k):
    rng = np.random.RandomState(0)
    A = rng.randn(6, 8).astype(np.float32)
    B = rng.randn(8, 8).astype(np.float32)
    X, _ = simulator.simulate_tile(torch.tensor(A), torch.tensor(B), k,
                                   use_csa=False)
    RX, _ = ref_sim.simulate_tile(jnp.asarray(A), jnp.asarray(B), k,
                                  use_csa=False)
    want = np.asarray(RX)
    np.testing.assert_allclose(X.numpy(), want, rtol=0,
                               atol=1e-6 * np.abs(want).max())
    np.testing.assert_allclose(X.numpy(), A @ B, rtol=1e-5, atol=1e-5)


@settings(max_examples=25, deadline=None)
@given(T=st.integers(1, 12),
       nr=st.integers(1, 3), nc=st.integers(1, 3),
       k=st.sampled_from([1, 2, 4]))
def test_tiled_matmul_property(T, nr, nc, k):
    """Tiled execution == plain matmul (which the reference's own
    property test holds its simulator to); cycles == Eq.(4)."""
    R = C = 8
    N, M = nr * R - 3, nc * C - 5          # deliberately ragged
    A, B = _int_pair(np.random.RandomState(T * 7 + nr * 3 + nc + k),
                     (T, N), (N, M), -64, 64)
    X, cycles = simulator.simulate_matmul(torch.tensor(A), torch.tensor(B),
                                          R, C, k)
    np.testing.assert_array_equal(X.numpy(), A @ B)
    assert cycles == timing.total_cycles(M, N, T, R, C, k)


@pytest.mark.parametrize("T,nr,nc,k", [(1, 1, 1, 1), (7, 2, 3, 2),
                                       (12, 3, 2, 4)])
def test_tiled_matmul_equals_reference(T, nr, nc, k):
    """Ragged tiled matmuls: the reference's result and cycles exactly."""
    R = C = 8
    N, M = nr * R - 3, nc * C - 5
    A, B = _int_pair(np.random.RandomState(T + k), (T, N), (N, M), -64, 64)
    X, cycles = simulator.simulate_matmul(torch.tensor(A), torch.tensor(B),
                                          R, C, k)
    RX, rcycles = ref_sim.simulate_matmul(jnp.asarray(A), jnp.asarray(B),
                                          R, C, k)
    np.testing.assert_array_equal(X.numpy(), np.asarray(RX))
    assert cycles == rcycles


def test_csa_compressor_bit_exact():
    rng = np.random.RandomState(1)
    x, y, z = (rng.randint(-2**20, 2**20, 50).astype(np.int32)
               for _ in range(3))
    s, c = simulator.csa_3_2(*map(torch.tensor, (x, y, z)))
    rs, rc = ref_sim.csa_3_2(*map(jnp.asarray, (x, y, z)))
    np.testing.assert_array_equal(s.numpy(), np.asarray(rs))
    np.testing.assert_array_equal(c.numpy(), np.asarray(rc))
    np.testing.assert_array_equal((s + c).numpy(), x + y + z)


def test_occupancy_trace_totals():
    T, R, C, k = 5, 8, 8, 2
    tr = simulator.occupancy_trace(T, R, C, k)
    np.testing.assert_array_equal(tr, ref_sim.occupancy_trace(T, R, C, k))
    assert tr.sum() == T * (C // k) * (R // k)


def test_resnet34_paper_anchors():
    ls = cnn_shapes.resnet34_layers()
    assert ls[19].mnt == (256, 2304, 196)    # paper layer 20
    assert ls[27].mnt == (512, 2304, 49)     # paper layer 28
    assert len(ls) == 34                     # 33 convs + fc


@pytest.mark.parametrize("net", ["resnet34", "mobilenet", "convnext"])
def test_network_shapes_equal_reference(net):
    assert cnn_shapes.network_mnt(net) == ref_shapes.network_mnt(net)
    assert len(cnn_shapes.mobilenet_layers()) == 1 + 13 * 2 + 1
    assert len(cnn_shapes.convnext_layers()) == 1 + 3 + 18 * 3 + 1


def test_normal_mode_costs_more_than_conventional():
    assert power.power_arrayflex(1) > power.power_conventional()


@pytest.mark.parametrize("R", [128, 256])
@pytest.mark.parametrize("net", ["resnet34", "mobilenet", "convnext"])
def test_full_run_savings_equal_reference(net, R):
    """The port's planner over the port's shapes: the reference's savings
    exactly, inside the paper's envelope."""
    res = planner.plan_network(
        [planner.GEMM(f"l{i}", *mnt)
         for i, mnt in enumerate(cnn_shapes.network_mnt(net))], R, R)
    want = ref_planner.plan_network(
        [ref_planner.GEMM(f"l{i}", *mnt)
         for i, mnt in enumerate(ref_shapes.network_mnt(net))], R, R)
    for key in ("latency_saving", "power_saving", "edp_gain"):
        assert res[key] == want[key], key
    assert 0.05 < res["latency_saving"] < 0.16
    assert 0.08 < res["power_saving"] < 0.30
    assert 1.25 < res["edp_gain"] < 2.0
