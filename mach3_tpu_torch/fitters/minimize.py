"""Gradient-based maximum-likelihood fit, the Minuit2 Migrad + Hesse
counterpart (port of ``mach3_tpu/fitters/minimize.py``; the reference's
``Fitters/LikelihoodFit.cpp`` and ``MinuitFit.cpp``).

χ² = 2 x (prior −logL + sample −logL) with no out-of-bounds sentinel
(``LikelihoodFit.cpp:39-139``) is minimised by scipy's L-BFGS-B with exact
gradients: value and gradient come from ``FitModel.log_posterior_batch`` at
C = 1, so every evaluation runs the fused forward kernels and the
hand-written backward (``splines/grad.py``). Bounds go to the optimiser.
The postfit covariance is 2 H⁻¹ of χ²'s exact Hessian, taken by
``torch.autograd.functional.hessian`` through the plain route (the kernels'
backward is first order only).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.logging import get_logger
from ..core.precision import ATYPE
from .model import FitModel

_log = get_logger("minimize")


@dataclasses.dataclass
class FitResult:
    x: np.ndarray  # best-fit parameters
    chi2: float  # 2 x -logL at the minimum
    covariance: np.ndarray | None  # 2 H⁻¹ (the Hesse step)
    errors: np.ndarray | None  # sqrt(diag(covariance))
    success: bool
    n_evaluations: int  # value-and-gradient evaluations (each one forward + backward)
    message: str


def chi2_batch(model: FitModel, x: torch.Tensor) -> torch.Tensor:
    """``CalcChi2`` of a batch x [C, NP] -> [C] (JAX ``minimize.py:_chi2_of``):
    2 x (the quadratic prior without the out-of-bounds sentinel + the
    samples' -logL, each sample on its route). The sentinel-free χ² that a
    bounded optimiser needs (``LikelihoodFit.cpp:98``)."""
    flat = model.flat
    d = torch.where(flat.flat_prior, 0.0, x.to(ATYPE) - flat.prefit)
    prior = 0.5 * (d * (d @ flat.inv_cov.T)).sum(1)
    return 2.0 * (prior + model.total_nll_batch_parts(x)[2].sum(1))


def bounds_of(model: FitModel) -> list[tuple[float, float]]:
    """(low, high) of every parameter, handler by handler."""
    out = []
    for prior in model.priors:
        out.extend(zip(prior.low_bound.tolist(), prior.up_bound.tolist()))
    return out


def shift_params(model: FitModel) -> list[int]:
    """Indices of the parameters of the samples' kinematic shifts (an energy
    scale). A shift moves events across bin edges, so χ² is a staircase in
    its parameter and the gradient there is zero: a gradient fit holds these
    fixed (``run_minimizer(fixed=...)``), or L-BFGS-B stalls on a step."""
    return sorted({sh.param_index for s in model.samples for sh in s.shifts})


def run_minimizer(
    model: FitModel,
    x0: np.ndarray | None = None,
    run_hesse: bool = True,
    fixed: np.ndarray | None = None,
    maxiter: int = 2000,
) -> FitResult:
    """Migrad + Hesse equivalent (``MinuitFit.cpp:41-120``). Parameters fixed
    in their handler or by ``fixed`` [NP] bool stay at ``x0`` (default: the
    prefit vector); see :func:`shift_params` for those to fix."""
    from scipy.optimize import minimize

    device = model.flat.prefit.device
    if x0 is None:
        x0 = model.prefit_vector().cpu().numpy()
    x0 = np.asarray(x0, np.float64)
    fixed_mask = np.zeros(len(x0), bool) if fixed is None else np.asarray(fixed, bool).copy()
    for prior, (start, size) in zip(model.priors, model.slices):
        fixed_mask[start:start + size] |= prior.fixed.cpu().numpy()
    free = ~fixed_mask
    bounds_all = np.asarray(bounds_of(model))
    # L-BFGS-B runs on u = (x − x0) / σ, σ the prior width of each parameter
    # (Minuit's internal parameters are scaled by the step sizes too). On x
    # itself its first step is 1/|g| along −g, and with widths from 1e-6
    # (Δm²) to 1 that step is too short to move the f32 likelihood: it
    # stopped at x0 after 3 evaluations on the toy, in the JAX package too.
    chol = model.flat.chol.cpu().numpy()
    sigma = np.sqrt(np.diag(chol @ chol.T))
    sigma = np.where(sigma > 0, sigma, 1.0)[free]

    n_calls = 0

    def fun(uf):
        nonlocal n_calls
        n_calls += 1
        x = x0.copy()
        x[free] += uf * sigma
        theta = torch.tensor(x[None], dtype=ATYPE, device=device, requires_grad=True)
        chi2 = -2.0 * model.log_posterior_batch(theta)[0]
        (g,) = torch.autograd.grad(chi2, theta)
        return float(chi2.detach()), g[0].cpu().numpy()[free] * sigma

    u_bounds = (bounds_all[free] - x0[free, None]) / sigma[:, None]
    res = minimize(fun, np.zeros(int(free.sum())), jac=True, method="L-BFGS-B",
                   bounds=[tuple(b) for b in u_bounds], options={"maxiter": maxiter})
    x_best = x0.copy()
    x_best[free] += res.x * sigma

    cov = errors = None
    if run_hesse:
        h = torch.autograd.functional.hessian(
            lambda th: -2.0 * model.log_posterior(th, plain=True),
            torch.tensor(x_best, dtype=ATYPE, device=device),
        ).cpu().numpy()
        try:
            cov_free = 2.0 * np.linalg.inv(h[np.ix_(free, free)])  # χ² = 2·nll
            cov = np.zeros((len(x0), len(x0)))
            cov[np.ix_(free, free)] = cov_free
            errors = np.sqrt(np.maximum(np.diag(cov), 0.0))
        except np.linalg.LinAlgError:
            _log.warning("Hesse failed: singular Hessian")

    _log.info("Minimizer: chi2 = %.4f after %d evaluations (%s)", res.fun, n_calls,
              "converged" if res.success else res.message)
    return FitResult(x=x_best, chi2=float(res.fun), covariance=cov, errors=errors,
                     success=bool(res.success), n_evaluations=n_calls,
                     message=str(res.message))
