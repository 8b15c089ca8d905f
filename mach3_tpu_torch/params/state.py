"""Prior model and chain-batched proposal (port of ``mach3_tpu/params/state.py``).

* ``Randomize + CorrelateSteps`` (``ParameterHandlerBase.cpp:652-867``) -> one
  batch of standard normals and one [C, K] @ [K, P] product.
* ``SpecialStepProposal``: circular bounds then mass-ordering flips, in the
  reference order ("Step -> Circular Bounds -> Flip").
* ``CalcLikelihood``: the half quadratic form with flat priors skipped, f64.

Random draws come from an explicit ``torch.Generator``; tests inject them
(``z``, ``flip_u``) to run in lockstep with the JAX package.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..core.precision import ATYPE, LARGE_LOGL
from .parameterset import ParameterSet

_FIELDS = (
    "prefit", "inv_cov", "chol", "step_scale", "low_bound", "up_bound",
    "flat_prior", "fixed", "circ_mask", "circ_low", "circ_high",
    "flip_mask", "flip_point",
)
_BOOL_FIELDS = ("flat_prior", "fixed", "circ_mask", "flip_mask")


class PriorModel(nn.Module):
    """Static per-handler arrays as buffers (all f64, masks bool; P is small).

    prefit [P], inv_cov [P, P] (flat-prior rows/cols zeroed), chol [P, K]
    (throw factor), step_scale [P] (0 for fixed), low_bound/up_bound [P],
    flat_prior/fixed [P] bool, circ_mask/circ_low/circ_high [P],
    flip_mask/flip_point [P]."""

    def __init__(self, **arrays):
        super().__init__()
        missing = set(_FIELDS) - set(arrays)
        if missing:
            raise ValueError(f"PriorModel: missing fields {sorted(missing)}")
        for f in _FIELDS:
            x = arrays[f]
            if not isinstance(x, torch.Tensor):
                x = torch.from_numpy(np.array(x))
            self.register_buffer(f, x.to(torch.bool if f in _BOOL_FIELDS else ATYPE))

    @property
    def n_params(self) -> int:
        return self.prefit.shape[0]

    @classmethod
    def from_parameter_set(cls, ps: ParameterSet) -> "PriorModel":
        flat = ps.flat_prior.astype(bool)
        # Flat-prior parameters contribute nothing to the Gaussian penalty:
        # zero their rows/columns of the inverse covariance up front.
        inv_cov = np.linalg.inv(ps.covariance)
        keep = (~flat).astype(np.float64)
        inv_cov = inv_cov * np.outer(keep, keep)
        # The prior uses the nominal covariance; the PROPOSAL uses the throw
        # matrix (or, with PCA, the rectangular reduced-basis factor with the
        # step scales folded in, ``PCAHandler.cpp:194-226``).
        if ps.pca is not None:
            from ..core.exceptions import ConfigError

            pca = ps.pca
            p = len(ps)
            in_block = np.zeros(p, bool)
            in_block[pca.first : pca.last + 1] = True
            if np.any(ps.fixed & in_block):
                raise ConfigError(
                    "Fixed parameters inside the PCA block are not supported "
                    "(elementwise zeroing would rotate throws out of the kept "
                    "subspace); fix them outside the block or shrink the block"
                )
            chol = np.array(pca.throw_matrix, np.float64)
            chol[:, : pca.n_kept] *= ps.step_scales[pca.first] * ps.global_step_scale
            out_rows = ~in_block
            row_scale = ps.step_scales * ps.global_step_scale * (~ps.fixed)
            chol[out_rows, pca.n_kept :] *= row_scale[out_rows, None]
            scale = np.ones(p)
        else:
            chol = np.linalg.cholesky(ps.throw_matrix)
            scale = ps.step_scales * ps.global_step_scale * (~ps.fixed)
        return cls(
            prefit=ps.prefit,
            inv_cov=inv_cov,
            chol=chol,
            step_scale=scale,
            low_bound=ps.low_bounds,
            up_bound=ps.up_bounds,
            flat_prior=flat,
            fixed=ps.fixed.astype(bool),
            circ_mask=ps.circ_mask.astype(bool),
            circ_low=ps.circ_low,
            circ_high=ps.circ_high,
            flip_mask=ps.flip_mask.astype(bool),
            flip_point=ps.flip_point,
        )


def circular_wrap(
    value: torch.Tensor, low: torch.Tensor, high: torch.Tensor
) -> torch.Tensor:
    """Wrap into [low, high] with the reference's fmod semantics
    (``ParameterHandlerBase.cpp:769-778`` ``CircularParBounds``)."""
    width = high - low
    above = low + torch.fmod(value - high, width)
    below = high - torch.fmod(low - value, width)
    return torch.where(value > high, above, torch.where(value < low, below, value))


def propose_step_batch(
    model: PriorModel,
    current: torch.Tensor,
    generator: torch.Generator | None = None,
    z: torch.Tensor | None = None,
    flip_u: torch.Tensor | None = None,
    extra_scale: float = 1.0,
    scale: torch.Tensor | None = None,
) -> torch.Tensor:
    """Correlated proposals for a chain batch: current [C, P] -> [C, P].

    ``z [C, K]`` (standard normals) and ``flip_u [C, P]`` (uniforms; a flip
    parameter flips where ``flip_u < 0.5``) may be injected — the batch form
    of the reference's ``SetRandomThrow`` hook; otherwise they are drawn from
    ``generator``, normals first. ``extra_scale`` multiplies every step (the
    delayed-rejection cascade's shrink factor); ``scale [C]`` multiplies each
    chain's step (parallel tempering throws each level at its own scale)."""
    c = current.shape[0]
    dev = current.device
    if z is None:
        z = torch.randn(
            (c, model.chol.shape[1]), generator=generator, dtype=ATYPE, device=dev
        )
    if flip_u is None:
        flip_u = torch.rand(
            (c, model.n_params), generator=generator, dtype=ATYPE, device=dev
        )
    # Fixed params have step_scale 0, so they never move.
    delta = (z.to(ATYPE) @ model.chol.T) * model.step_scale * extra_scale
    if scale is not None:
        delta = delta * scale[:, None]
    prop = current + delta

    wrapped = circular_wrap(prop, model.circ_low, model.circ_high)
    prop = torch.where(model.circ_mask & ~model.fixed, wrapped, prop)

    flipped = 2.0 * model.flip_point - prop
    do_flip = model.flip_mask & ~model.fixed & (flip_u < 0.5)
    return torch.where(do_flip, flipped, prop)


def prior_logl(model: PriorModel, prop: torch.Tensor) -> torch.Tensor:
    """Gaussian prior -logL, 1/2 d^T V^-1 d with flat priors excluded
    (``ParameterHandlerBase.cpp:816-841``): prop [..., P] -> [...] f64."""
    d = torch.where(model.flat_prior, 0.0, prop.to(ATYPE) - model.prefit)
    return 0.5 * (d * (d @ model.inv_cov.T)).sum(-1)


def propose_step(
    model: PriorModel,
    current: torch.Tensor,
    generator: torch.Generator | None = None,
    z: torch.Tensor | None = None,
    flip_u: torch.Tensor | None = None,
) -> torch.Tensor:
    """One chain's correlated proposal, current [P] -> [P]: the batch form
    at C = 1 (``z [K]`` and ``flip_u [P]`` may be injected)."""
    return propose_step_batch(
        model, current[None], generator,
        z=None if z is None else z[None], flip_u=None if flip_u is None else flip_u[None],
    )[0]


def count_out_of_bounds(model: PriorModel, prop: torch.Tensor) -> torch.Tensor:
    """Number of parameters outside the physical bounds (``CheckBounds``,
    ``ParameterHandlerBase.cpp:844-856``): prop [..., P] -> [...] int32."""
    outside = (prop > model.up_bound) | (prop < model.low_bound)
    return outside.sum(-1, dtype=torch.int32)


def get_likelihood(model: PriorModel, prop: torch.Tensor) -> torch.Tensor:
    """Prior -logL with the out-of-bounds sentinel (``GetLikelihood``,
    ``:859-867``): ``NOutside * LARGE_LOGL`` where any parameter is out of
    bounds, else :func:`prior_logl`. prop [..., P] -> [...] f64."""
    n_out = count_out_of_bounds(model, prop)
    return torch.where(n_out > 0, n_out.to(ATYPE) * LARGE_LOGL, prior_logl(model, prop))
