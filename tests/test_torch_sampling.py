"""The port's temperature sampler draws from the reference's distribution.

``ServingEngine._sample`` in the port (``torch.multinomial`` over the
softmax of logits / T, from the engine's seeded ``torch.Generator``) and
in the reference (``jax.random.categorical`` from its split PRNG key)
cannot give the same draws, only the same distribution.  Each is called
once on N = 20000 rows of one fixed logit vector at each temperature
(each row an independent draw), and every category's empirical
frequency f must lie within 5 standard errors of the softmax
probability p, sqrt(p (1 - p) / N), and the two packages' frequencies
within 5 standard errors of their difference, sqrt(2 p (1 - p) / N).
The seeds are fixed, so the test is deterministic; a 5-sigma bound
holds for a correct sampler at these seeds with probability above
1 - 1e-5 per category.  Rows at temperature 0 take the argmax in both.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serving.engine import ServingEngine as RefEngine
from repro_torch.serving.engine import ServingEngine

N = 20000
LOGITS = np.array([2.0, 1.0, 0.5, 0.0, -1.0, -3.0], np.float32)
SIGMAS = 5.0


class _PortStub:
    def __init__(self, seed):
        self.gen = torch.Generator().manual_seed(seed)


class _RefStub:
    def __init__(self, seed):
        self.key = jax.random.PRNGKey(seed)


def _draw(temps, seed=0):
    rows = np.tile(LOGITS, (len(temps), 1))
    got = ServingEngine._sample(_PortStub(seed), torch.tensor(rows),
                                np.asarray(temps, np.float32))
    want = RefEngine._sample(_RefStub(seed), jnp.asarray(rows),
                             jnp.asarray(temps, jnp.float32))
    return np.asarray(got), np.asarray(want)


def _softmax(t):
    z = LOGITS.astype(np.float64) / t
    e = np.exp(z - z.max())
    return e / e.sum()


@pytest.mark.parametrize("temp", [0.5, 1.0, 2.0])
def test_sampler_draws_the_reference_distribution(temp):
    got, want = _draw(np.full(N, temp))
    p = _softmax(temp)
    V = len(LOGITS)
    f_got = np.bincount(got, minlength=V) / N
    f_want = np.bincount(want, minlength=V) / N
    se = np.sqrt(p * (1 - p) / N)
    assert (np.abs(f_got - p) <= SIGMAS * se + 1e-12).all(), (f_got, p)
    assert (np.abs(f_want - p) <= SIGMAS * se + 1e-12).all(), (f_want, p)
    assert (np.abs(f_got - f_want)
            <= SIGMAS * np.sqrt(2) * se + 1e-12).all(), (f_got, f_want)


def test_zero_temperature_rows_are_greedy_in_both():
    temps = np.tile(np.array([0.0, 1.0], np.float32), 500)
    got, want = _draw(temps)
    assert (got[temps == 0] == 0).all() and (want[temps == 0] == 0).all()
    # the sampled rows do leave the argmax sometimes in both
    assert (got[temps > 0] != 0).any() and (want[temps > 0] != 0).any()
