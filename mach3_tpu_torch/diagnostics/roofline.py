"""Roofline accounting for the per-step likelihood: bytes moved and
operations per component against the card's peaks (port of
``mach3_tpu/diagnostics/roofline.py``; BASELINE.md "speed-of-light per
chip").

The budget is derived from a :class:`~mach3_tpu_torch.fitters.model.FitModel`'s
logical shapes: each sample's real events (its layout's zero-weight pads
left out), parameters and bins, and the JAX package's definition of each
component's work, so that the yardstick reads the same work whatever
implements it and a later layout change does not move it:

* **Memory bytes** — per step at C chains, each sample moves its spline
  coefficient table once (for all chains), a handful of [C, E] f32 passes
  for the base weight (oscillation gather, norm product, MC weight), the
  [NA+1, E] norm match counts once, and the [C, 2B] histograms out.
* **Operations** — the spline contraction (the JAX package's selector
  [C, K4] x coefficients [K4, E] per parameter) and the norm product's three
  [C, NA+1] x [NA+1, E] contractions, counted as f32 operations.
* **f64 transcendentals** — the oscillation eigensolves' square roots and
  trigonometry, counted without a time in the floors, as the JAX package
  counts them. ``report``'s ``f64_lower_bound_ms`` counts each as one f64
  operation at the f64 peak: a lower bound only, since one f64 square root,
  sine or cosine is many operations on Hopper, so it enters no floor.

Peaks default to one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates):
3.35 TB/s of HBM, 67 TFLOP/s f32 and 34 TFLOP/s f64 outside the tensor
cores — the figures ``chip_smoke.py``'s kernel bounds use.
"""
from __future__ import annotations

import dataclasses
from typing import Any

H100_HBM_GBPS = 3350.0
H100_F32_TFLOPS = 67.0
H100_F64_TFLOPS = 34.0


@dataclasses.dataclass
class ComponentBudget:
    name: str
    hbm_bytes: int = 0
    mxu_flops: int = 0  # f32 operations (the JAX package's MXU count)
    f64_transcendentals: int = 0

    def floor_ms(self, hbm_gbps: float = H100_HBM_GBPS,
                 mxu_tflops: float = H100_F32_TFLOPS) -> float:
        """The least time for the component: the larger of its bytes over
        the memory rate and its operations over the f32 peak."""
        t_mem = self.hbm_bytes / (hbm_gbps * 1e9)
        t_mxu = self.mxu_flops / (mxu_tflops * 1e12)
        return 1e3 * max(t_mem, t_mxu)


def real_events(s: Any) -> int:
    """A sample's events without its layout's zero-weight pads."""
    return s.n_events if s.event_pad is None else int((~s.event_pad).sum())


def sample_budget(s: Any, n_chains: int) -> list[ComponentBudget]:
    """Per-step budget of one SampleModel at C chains."""
    from ..samples.sample import AtmoOscConfig

    c, e, b = n_chains, real_events(s), s.n_bins
    f32 = 4
    out = []

    if s.osc is not None:
        osc = ComponentBudget(f"{s.name}:osc")
        ne = s.osc.e_grid.shape[0]
        if isinstance(s.osc, AtmoOscConfig):
            nz, nl = s.osc.layer_lengths.shape[-2], s.osc.layer_lengths.shape[-1]
            nh = 1 if s.osc.height_weights is None else len(s.osc.height_weights)
            nr = s.osc.rho_unique.shape[0]
            n_eig = 2 * c * nr * ne  # eigensolves: one per (rho, E) and chain, nu and nubar
            osc.f64_transcendentals = n_eig * 2 + 2 * c * nh * nz * nl * ne * 6
            osc.hbm_bytes = 2 * c * nz * ne * 9 * f32  # grids out
        else:
            osc.f64_transcendentals = 2 * c * ne * (2 + 6)
            osc.hbm_bytes = 2 * c * ne * 9 * f32
        osc.hbm_bytes += c * e * f32  # the per-event gather's [C, E] out
        out.append(osc)

    norm = ComponentBudget(f"{s.name}:norm")
    if s.norm_s is not None:
        na1 = s.norm_s.shape[0]
        norm.hbm_bytes = na1 * e * s.norm_s.element_size() + c * e * f32
        norm.mxu_flops = 2 * c * na1 * e * 3  # the log, negative and zero counts
    else:  # the gather form: the [E, W] indices once, [C, E] out
        norm.hbm_bytes = e * s.norm_idx.shape[1] * s.norm_idx.element_size() + c * e * f32
    out.append(norm)

    passes = 2 + (1 if s.tf1_table is not None else 0)
    out.append(ComponentBudget(f"{s.name}:base_w", hbm_bytes=passes * c * e * f32 + e * f32))

    if s.spline_table is not None and hasattr(s.spline_table, "coeffs"):
        tb = s.spline_table.coeffs  # dense [P, K4, E]
        p_dim, k4 = tb.shape[0], tb.shape[1]
        out.append(ComponentBudget(
            f"{s.name}:kernel",
            hbm_bytes=p_dim * k4 * e * tb.element_size() + c * e * f32 + 2 * c * b * f32,
            mxu_flops=2 * c * p_dim * k4 * e))

    out.append(ComponentBudget(f"{s.name}:llh", hbm_bytes=3 * c * b * 8))
    return out


def model_budget(model: Any, n_chains: int) -> list[ComponentBudget]:
    out = [ComponentBudget("proposal", hbm_bytes=3 * n_chains * model.n_params * 8,
                           mxu_flops=2 * n_chains * model.n_params**2)]
    # Samples sharing an oscillation signature: only the group's first pays
    # for the grids.
    groups = model.osc_groups or ()
    for i, s in enumerate(model.samples):
        comps = sample_budget(s, n_chains)
        if groups and groups[i] >= 0 and groups[i] != i:
            comps = [c for c in comps if not c.name.endswith(":osc")]
        out.extend(comps)
    return out


def report(model: Any, n_chains: int, measured_step_ms: float | None = None,
           hbm_gbps: float = H100_HBM_GBPS, mxu_tflops: float = H100_F32_TFLOPS) -> dict:
    """Budget dict: per-component bytes, operations and floors, totals, and
    (optionally) the measured step time's fraction of the memory floor —
    the keys of the JAX package's report; beside them
    ``f64_lower_bound_ms``, the f64 transcendentals at one operation each
    over the H100's f64 peak (a lower bound, in no floor)."""
    comps = model_budget(model, n_chains)
    total_bytes = sum(c.hbm_bytes for c in comps)
    total_flops = sum(c.mxu_flops for c in comps)
    total_f64 = sum(c.f64_transcendentals for c in comps)
    floor = sum(c.floor_ms(hbm_gbps, mxu_tflops) for c in comps)
    rep = {
        "n_chains": n_chains,
        "hbm_gbytes_per_step": round(total_bytes / 1e9, 4),
        "mxu_gflops_per_step": round(total_flops / 1e9, 2),
        "f64_transcendentals_per_step": int(total_f64),
        "memory_floor_ms": round(total_bytes / (hbm_gbps * 1e9) * 1e3, 3),
        "mxu_floor_ms": round(total_flops / (mxu_tflops * 1e12) * 1e3, 4),
        "combined_floor_ms": round(floor, 3),
        "components": {
            c.name: {
                "mbytes": round(c.hbm_bytes / 1e6, 2),
                "gflops": round(c.mxu_flops / 1e9, 2),
                "f64_transc": int(c.f64_transcendentals),
                "floor_ms": round(c.floor_ms(hbm_gbps, mxu_tflops), 4),
            }
            for c in comps
        },
        "f64_lower_bound_ms": round(total_f64 / (H100_F64_TFLOPS * 1e12) * 1e3, 4),
    }
    if measured_step_ms is not None:
        rep["measured_step_ms"] = round(measured_step_ms, 3)
        rep["fraction_of_memory_floor"] = round(rep["memory_floor_ms"] / measured_step_ms, 3)
    return rep
