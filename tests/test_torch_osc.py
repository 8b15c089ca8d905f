"""Port's beam oscillation probabilities vs the JAX package.

Tolerances follow tests/test_osc_external.py, at its beam configurations
plus the toy's energy grid: the f64 engine is held to 1e-6 there (here to
1e-12: same algorithm, same f64 arithmetic); the f32 production path (f32
matrices, f32 or f64 phases) to 1e-4 — f32 transcendentals and Cardano's
arccos round differently in the two libraries.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mach3_tpu.osc.prob import OscParams as JOscParams
from mach3_tpu.osc.prob import probabilities_const_density as jprob
from mach3_tpu_torch.osc.prob import OscParams, probabilities_const_density

torch.set_num_threads(1)

NUFIT = np.array([0.307, 0.0220, 0.561, -1.601, 7.42e-5, 2.51e-3])
NUFIT_IO = np.array([0.307, 0.0220, 0.563, -1.601, 7.42e-5, -2.43e-3])
DTYPES = {
    "f64": (jnp.float64, jnp.float64, torch.float64, torch.float64, 1e-12),
    "f32": (jnp.float32, jnp.float32, torch.float32, torch.float32, 1e-4),
    "f32_f64phase": (jnp.float32, jnp.float64, torch.float32, torch.float64, 1e-4),
}


@pytest.mark.parametrize("anti", [False, True], ids=["nu", "nubar"])
@pytest.mark.parametrize("dtypes", list(DTYPES))
def test_const_density_matches_jax(dtypes, anti):
    jdt, jpdt, tdt, tpdt, atol = DTYPES[dtypes]
    rng = np.random.default_rng(4)
    pars = np.stack([NUFIT, NUFIT_IO] + [
        NUFIT + rng.normal(size=6) * [0.01, 0.0007, 0.03, 0.5, 2e-6, 3e-5] for _ in range(3)
    ])
    beams = [  # test_osc_external.BEAMS, then the toy's grid (tutorial/toy.py)
        (295.0, 2.6, [0.4, 0.6, 0.8, 1.2]),
        (810.0, 2.8, [1.0, 1.6, 2.0, 3.0]),
        (1285.0, 2.848, [0.8, 1.5, 2.5, 4.0]),
        (295.0, 2.6, np.linspace(0.05, 3.0, 40)),
    ]
    for length, rho, energy in beams:
        energy = np.asarray(energy, np.float64)
        want = np.stack([
            np.asarray(jprob(JOscParams.from_array(jnp.asarray(p)), jnp.asarray(energy),
                             length=length, rho=rho, antineutrino=anti, dtype=jdt,
                             phase_dtype=jpdt))
            for p in pars
        ])
        got = probabilities_const_density(
            OscParams.from_array(torch.from_numpy(pars)), torch.from_numpy(energy),
            length=length, rho=rho, antineutrino=anti, dtype=tdt, phase_dtype=tpdt,
        )
        assert got.shape == (len(pars), len(energy), 3, 3) and got.dtype == tdt
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=atol)
        # unitarity: rows of P sum to 1
        np.testing.assert_allclose(got.sum(-1).numpy(), 1.0, atol=10 * atol)


def test_inputs_as_arrays_lists_and_numbers():
    """Energy, baseline and density may be tensors, numpy arrays, lists or
    numbers (Python or numpy), as ``torch.as_tensor`` takes them."""
    pars = OscParams.from_array(torch.from_numpy(NUFIT[None]))
    energy = [0.4, 0.6, 0.8]
    f64 = torch.float64
    want = probabilities_const_density(pars, torch.tensor(energy, dtype=f64),
                                       length=torch.tensor(295.0, dtype=f64),
                                       rho=torch.tensor(2.6, dtype=f64))
    for e, length, rho in ((energy, 295.0, 2.6), (np.asarray(energy), np.float64(295.0),
                                                  np.float64(2.6)), (energy, 295, 2.6)):
        got = probabilities_const_density(pars, e, length=length, rho=rho)
        assert got.shape == (1, 3, 3, 3)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-15)
