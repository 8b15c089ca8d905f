"""Port's six binned test statistics vs the JAX package, low-MC edges included.

Both evaluate in f64 with the same formulas; only IceCube's log-gamma
differs (torch.lgamma vs the JAX package's Lanczos series, ~1e-13
relative), so everything is held to rtol 1e-10.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mach3_tpu.samples import teststats as jts
from mach3_tpu_torch.samples import teststats as tts

torch.set_num_threads(1)


def _bins():
    rng = np.random.default_rng(7)
    data = rng.poisson(rng.uniform(0.5, 200.0, size=60)).astype(np.float64)
    mc = data * rng.uniform(0.7, 1.3, size=60) + rng.uniform(0, 1, size=60)
    w2 = mc * rng.uniform(0.01, 2.0, size=60)
    low = 1e-5  # LOW_MC_BOUND edges: data == 0, mc below the bound, w2 == 0
    edge = np.array([
        [0.0, 3.0, 1.0], [0.0, 0.0, 0.0], [5.0, 1e-7, 1e-9], [5e-6, 1e-7, 1e-9],
        [1e-7, 5e-6, 1e-9], [4.0, 4.0, 0.0], [0.0, 2.0, 0.0], [low, low, low],
        [3.0, 1e-6, 0.0], [2.0, 2.0, 4.0],
    ])
    return (np.concatenate([data, edge[:, 0]]), np.concatenate([mc, edge[:, 1]]),
            np.concatenate([w2, edge[:, 2]]))


@pytest.mark.parametrize("stat", list(tts.TestStatistic), ids=lambda s: s.value)
def test_statistic_matches_jax(stat):
    data, mc, w2 = _bins()
    want = np.asarray(jts.get_test_stat_fn(stat.value)(
        jnp.asarray(data), jnp.asarray(mc), jnp.asarray(w2)))
    got = tts.get_test_stat_fn(stat)(
        torch.from_numpy(data), torch.from_numpy(mc), torch.from_numpy(w2))
    assert got.dtype == torch.float64
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-10, atol=1e-12)
    # batched over chains: [C, B] mc/w2 against [B] data
    batched = tts.get_test_stat_fn(stat)(
        torch.from_numpy(data), torch.from_numpy(np.stack([mc, 1.1 * mc])),
        torch.from_numpy(np.stack([w2, w2])))
    np.testing.assert_array_equal(batched[0].numpy(), got.numpy())
