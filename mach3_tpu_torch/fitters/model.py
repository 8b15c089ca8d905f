"""The fit model (port of ``mach3_tpu/fitters/model.py``).

Replaces the reference's object wiring (``FitterBase::AddSystObj`` /
``AddSampleHandler``, ``Fitters/FitterBase.cpp:262-345``): a :class:`FitModel`
holds the per-handler :class:`PriorModel` blocks, one whole-vector prior
(block-diagonal inverse covariance and Cholesky factor), and the samples.
Every step quantity is a function of the chain batch θ [C, NP].
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
from torch import nn

from ..core.collectives import all_reduce_sum
from ..core.precision import ATYPE, LARGE_LOGL
from ..params.parameterset import ParameterSet
from ..params.state import PriorModel, propose_step
from ..samples.sample import SampleModel


def _flatten_priors(priors: Sequence[PriorModel]) -> PriorModel:
    """Assemble per-handler blocks into one full-vector PriorModel."""

    def cat(field):
        return torch.cat([getattr(p, field) for p in priors])

    def blockdiag(field):
        return torch.block_diag(*[getattr(p, field) for p in priors])

    fields = ("prefit", "step_scale", "low_bound", "up_bound", "flat_prior", "fixed",
              "circ_mask", "circ_low", "circ_high", "flip_mask", "flip_point")
    return PriorModel(
        inv_cov=blockdiag("inv_cov"), chol=blockdiag("chol"),
        **{f: cat(f) for f in fields},
    )


class FitModel(nn.Module):
    """priors: per-handler blocks; slices: (start, size) of each block in θ;
    flat: all blocks as one PriorModel; osc_groups[i]: index of the first
    sample with sample i's oscillation signature (-1: no oscillation)."""

    def __init__(self, priors: Sequence[PriorModel], samples: Sequence[SampleModel],
                 slices: Sequence[tuple[int, int]], flat: PriorModel | None = None,
                 osc_groups: tuple | None = None):
        super().__init__()
        self.priors = nn.ModuleList(priors)
        self.samples = nn.ModuleList(samples)
        self.slices = tuple(slices)
        self.flat = flat if flat is not None else _flatten_priors(priors)
        self.osc_groups = (
            osc_groups if osc_groups is not None else self._compute_osc_groups(samples)
        )
        ids = np.concatenate(
            [np.full(size, h) for h, (_, size) in enumerate(self.slices)]
        )
        onehot = (ids[None, :] == np.arange(len(self.slices))[:, None]).astype(np.float64)
        self.register_buffer("block_onehot", torch.from_numpy(onehot), persistent=False)

    @property
    def n_params(self) -> int:
        start, size = self.slices[-1]
        return start + size

    @staticmethod
    def _compute_osc_groups(samples: Sequence[SampleModel]) -> tuple:
        by_sig: dict = {}
        groups = []
        for i, s in enumerate(samples):
            sig = s.osc_share_signature()
            groups.append(-1 if sig is None else by_sig.setdefault(sig, i))
        return tuple(groups)

    @classmethod
    def build(
        cls, parameter_sets: Sequence[ParameterSet], samples: Sequence[SampleModel]
    ) -> "FitModel":
        priors = []
        slices = []
        start = 0
        for ps in parameter_sets:
            priors.append(PriorModel.from_parameter_set(ps))
            slices.append((start, len(ps)))
            start += len(ps)
        return cls(priors, samples, slices)

    def prefit_vector(self) -> torch.Tensor:
        return self.flat.prefit.clone()

    def parameter_names(self, parameter_sets: Sequence[ParameterSet]) -> list[str]:
        """``<set name>_<parameter name>`` of every parameter, in θ's order."""
        return [f"{ps.name}_{n}" for ps in parameter_sets for n in ps.names]

    # ------------------------------------------------ one chain: θ [NP]
    # Each is the batched method at C = 1: one route, the kernels' on the card.
    def propose(self, theta: torch.Tensor, generator: torch.Generator | None = None,
                z: torch.Tensor | None = None, flip_u: torch.Tensor | None = None
                ) -> torch.Tensor:
        """Correlated proposal over all handlers, θ [NP] -> θ' [NP]
        (``params.state.propose_step`` on the whole-vector prior)."""
        return propose_step(self.flat, theta, generator, z=z, flip_u=flip_u)

    def prior_nll(self, theta: torch.Tensor) -> torch.Tensor:
        """Total prior -logL with the out-of-bounds sentinels (the sum of
        :meth:`prior_nll_breakdown`)."""
        return self.prior_nll_breakdown(theta).sum(-1)

    def sample_nll_breakdown(self, theta: torch.Tensor) -> torch.Tensor:
        """[S] per-sample -logL at θ (the reference's ``sample_llh``
        branches), oscillation grids shared by signature."""
        return self.total_nll_batch_parts(theta[None])[2][0]

    def sample_nll(self, theta: torch.Tensor) -> torch.Tensor:
        """Sum of the sample -logLs at θ (``LikelihoodFit::CalcChi2``'s)."""
        return self.sample_nll_breakdown(theta).sum()

    def total_nll(self, theta: torch.Tensor) -> torch.Tensor:
        """Full -logL at θ with the out-of-bounds short-circuit of
        ``MR2T2::ProposeStep``: ``prior + n_samples * LARGE_LOGL`` when the
        prior is at the sentinel."""
        return self.total_nll_batch(theta[None])[0]

    # --------------------------------------------------------- likelihood
    def prior_nll_breakdown(self, thetas: torch.Tensor) -> torch.Tensor:
        """[..., NP] -> [..., H] per-handler prior -logL: the half quadratic
        form per block, or ``NOutside * LARGE_LOGL`` for a block with
        out-of-bounds parameters (``MR2T2.cpp:25-50``)."""
        flat = self.flat
        d = torch.where(flat.flat_prior, 0.0, thetas.to(ATYPE) - flat.prefit)
        contrib = d * (d @ flat.inv_cov.T)  # block-diag: per-block quad pieces
        quad = 0.5 * (contrib @ self.block_onehot.T)
        outside = (thetas > flat.up_bound) | (thetas < flat.low_bound)
        n_out = outside.to(ATYPE) @ self.block_onehot.T
        return torch.where(n_out > 0.5, n_out * LARGE_LOGL, quad)

    def total_nll_batch(self, thetas: torch.Tensor) -> torch.Tensor:
        """[C, NP] -> [C] total -logL on each sample's route."""
        return self.total_nll_batch_parts(thetas)[0]

    def total_nll_batch_parts(
        self, thetas: torch.Tensor, event_group=None
    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Total -logL [C] with its per-handler [C, H] and per-sample [C, S]
        pieces (the reference's ``LogL_systematic_*`` / ``LogL_sample_*``
        branches, ``FitterBase.cpp:185-197``). When the prior is at the
        out-of-bounds sentinel, the sample term is replaced by
        ``n_samples * LARGE_LOGL`` (``MR2T2::ProposeStep``).

        ``event_group``: the process group over which an event-sharded
        model's samples are split (``distributed/mesh.shard_fit_model``).
        Every sample's partial histograms are summed over it in one
        all-reduce before the statistics; the prior is computed on every
        rank alike."""
        prior_parts = self.prior_nll_breakdown(thetas)
        prior = prior_parts.sum(1)
        oob = prior >= LARGE_LOGL
        if len(self.samples):
            tables = self._shared_osc_tables(thetas)
            if event_group is None:
                parts = [s.log_likelihood_batch(thetas, osc_grids_batch=tables[i])
                         for i, s in enumerate(self.samples)]
            else:
                hists = all_reduce_sum([h for i, s in enumerate(self.samples)
                                        for h in s.reweight_batch(thetas, tables[i])],
                                       event_group)
                parts = [s._stat_sum(hists[2 * i], hists[2 * i + 1])
                         for i, s in enumerate(self.samples)]
            sample_parts = torch.stack(parts, dim=1)
        else:
            sample_parts = torch.zeros((thetas.shape[0], 0), dtype=ATYPE, device=thetas.device)
        sample = sample_parts.sum(1)
        total = prior + torch.where(oob, len(self.samples) * LARGE_LOGL, sample)
        return total, prior_parts, sample_parts

    def log_posterior_batch(self, thetas: torch.Tensor, plain: bool = False) -> torch.Tensor:
        """[C, NP] -> [C] differentiable log-density, the gradient samplers'
        and the minimiser's counterpart of :meth:`total_nll_batch`:
        −(prior + Σ sample −logL). Oscillation grids are computed once per
        signature, the prior is one whole-vector quadratic form, and each
        sample runs :meth:`SampleModel.log_likelihood_batch_diff` (fused
        forward, hand-written backward), or with ``plain=True``
        :meth:`SampleModel.log_likelihood_batch_plain` (plain torch ops,
        differentiable to any order). No out-of-bounds sentinel: hard bounds
        are the caller's (HMC masks them to −inf outside the gradient)."""
        flat = self.flat
        d = torch.where(flat.flat_prior, 0.0, thetas.to(ATYPE) - flat.prefit)
        total = -0.5 * (d * (d @ flat.inv_cov.T)).sum(1)
        tables = self._shared_osc_tables(thetas)
        for i, s in enumerate(self.samples):
            nll = s.log_likelihood_batch_plain if plain else s.log_likelihood_batch_diff
            total = total - nll(thetas, tables[i])
        return total

    def log_posterior(self, theta: torch.Tensor, plain: bool = False) -> torch.Tensor:
        """The log-density of one θ [NP] (a batch of one)."""
        return self.log_posterior_batch(theta[None], plain=plain)[0]

    def _shared_osc_tables(self, thetas: torch.Tensor) -> list:
        """Per-sample oscillation grids, computed once per unique signature
        (``OscillationHandler.cpp:18-35``, "up to 12x" saving)."""
        tables: list = [None] * len(self.samples)
        cache: dict = {}
        for i, g in enumerate(self.osc_groups):
            if g < 0:
                continue
            if g not in cache:
                cache[g] = self.samples[g].osc_prob_grids(thetas)
            tables[i] = cache[g]
        return tables
