"""The plain reference likelihood: prior plus every sample's binned
Barlow-Beeston statistic, for a chain batch θ [C, P], from the benchmark's
inputs alone.

Per sample and chain: each event's weight is its MC weight x its
oscillation probability (nearest grid energy, and zenith, of its channel;
1 for NC) x the product of its matched normalisations x the product of its
spline responses; the energy scale moves E_reco (in float32, as the
configuration stores kinematics) before the binning; Σw and Σw² per bin;
the statistic per bin against the data, summed. The prior is half the
squared pull of every parameter that is not flat; a parameter outside its
bounds puts the chain at the sentinel (``LARGE_LOGL`` per outside parameter
of its block, plus ``LARGE_LOGL`` per sample).

``precision`` names the dtypes of the stages: ``weights`` (oscillation,
responses and products per event), ``sums`` (the histograms), ``stat`` and
``total`` (the prior, the sums over bins and samples). The reference runs
all of them in float64; the control runs each one step below what the
configuration states.
"""
from __future__ import annotations

import numpy as np
import torch

from . import osc as osc_ref
from . import splines as spl
from .params import norm_matches, read
from .stats import barlow_beeston

LARGE_LOGL = 1234567890.0
F64 = {"weights": torch.float64, "sums": torch.float64, "stat": torch.float64,
       "total": torch.float64}
_NAMES = {"float64": torch.float64, "float32": torch.float32, "bfloat16": torch.bfloat16}
_BELOW = {torch.float64: torch.float32, torch.float32: torch.bfloat16,
          torch.bfloat16: torch.bfloat16}
_FLAVOUR = {12: 0, 14: 1, 16: 2}


def control_precision(stated: dict) -> dict:
    """One step below the configuration's stated precision at every stage:
    float32 -> bfloat16, float64 -> float32."""
    def below(key):
        return _BELOW[_NAMES[stated.get(key, "float64")]]
    return {"weights": below("weights"), "sums": below("histograms"),
            "stat": below("statistic"), "total": below("theta")}


def _nearest(grid: np.ndarray, vals: np.ndarray) -> np.ndarray:
    """Index of the nearest grid point, ties to the upper one."""
    idx = np.clip(np.searchsorted(grid, vals), 0, len(grid) - 1)
    left = np.clip(idx - 1, 0, len(grid) - 1)
    return np.where(np.abs(grid[left] - vals) < np.abs(grid[idx] - vals), left, idx)


class _Sample:
    """A sample's static arrays on the device (float64 unless stated)."""

    def __init__(self, s, params, data, osc_index, nc_modes, table, device):
        dev = device
        self.name = s.name
        self.n_bins = s.n_bins
        self.mc_weight = torch.as_tensor(s.mc_weight, device=dev).to(torch.float64)
        pre, det = s.preosc_pdg, s.pdg
        if np.any((pre > 0) != (det > 0)):
            raise ValueError(f"{s.name}: a channel mixes neutrinos and antineutrinos")
        self.alpha = torch.as_tensor(np.vectorize(_FLAVOUR.get)(np.abs(pre)), device=dev)
        self.beta = torch.as_tensor(np.vectorize(_FLAVOUR.get)(np.abs(det)), device=dev)
        self.anti = torch.as_tensor(pre < 0, device=dev)
        self.nc = torch.as_tensor(np.isin(s.mode, nc_modes), device=dev)
        o = s.osc
        self.osc = o
        self.e_idx = torch.as_tensor(_nearest(o["e_grid"], s.kin["e_true"].astype(np.float64)),
                                     device=dev)
        self.e_grid = torch.as_tensor(o["e_grid"], dtype=torch.float64, device=dev)
        if o["kind"] == "atmo":
            self.z_idx = torch.as_tensor(
                _nearest(o["cosz_grid"], s.kin["cos_zenith"].astype(np.float64)), device=dev)
            self.paths = osc_ref.prem_paths(o["cosz_grid"], o["production_height_km"])
        self.osc_index = torch.as_tensor(osc_index, device=dev)
        # Each event's matched normalisations as columns of parameter
        # indices, padded with P (a column of ones).
        ev, par = norm_matches(params, s)
        order = np.lexsort((par, ev))
        ev, par = ev[order], par[order]
        pos = np.arange(len(ev)) - np.searchsorted(ev, ev)
        width = int(pos.max()) + 1 if len(ev) else 0
        cols = np.full((width, s.n_events), len(params.names), np.int64)
        cols[pos, ev] = par
        self.norm_cols = torch.as_tensor(cols, device=dev)
        from ..fixtures import SIGMA_KNOTS
        self.knots = torch.as_tensor(SIGMA_KNOTS, dtype=torch.float64, device=dev)
        self.splines = [(p, torch.as_tensor(ev, device=dev), co.to(dev)) for p, ev, co in table]
        # Binning: float32 values against float32 edges, row-major flat index.
        self.bin_rows = [s.var_order.index(v) for v in s.bin_vars]
        self.kin = torch.stack([torch.as_tensor(s.kin[v], device=dev) for v in s.var_order])
        self.edges = [torch.as_tensor(np.asarray(e, np.float64), device=dev).to(torch.float32)
                      for e in s.edges]
        self.shift = s.shift
        self.data = None if data is None else torch.as_tensor(np.asarray(data, np.float64),
                                                              device=dev)

    def prob_table(self, theta: torch.Tensor, grids: dict) -> torch.Tensor:
        """Oscillation weight per (chain, event), float64."""
        key = self.osc["kind"], id(self.osc["e_grid"])
        o = self.osc
        th = theta.index_select(1, self.osc_index).to(torch.float64)
        if key not in grids:
            if o["kind"] == "beam":
                grids[key] = [osc_ref.beam(th, self.e_grid, o["baseline_km"], o["density"], a)
                              for a in (False, True)]
            else:
                grids[key] = [osc_ref.layered(th, self.e_grid, self.paths, a)
                              for a in (False, True)]
        nu, bar = grids[key]
        if o["kind"] == "beam":
            p_nu = nu[:, self.e_idx, self.alpha, self.beta]
            p_bar = bar[:, self.e_idx, self.alpha, self.beta]
        else:
            p_nu = nu[:, self.z_idx, self.e_idx, self.alpha, self.beta]
            p_bar = bar[:, self.z_idx, self.e_idx, self.alpha, self.beta]
        p = torch.where(self.anti, p_bar, p_nu)
        return torch.where(self.nc, torch.ones_like(p), p)

    def bins(self, theta: torch.Tensor) -> torch.Tensor:
        """[C, E] flat bin (n_bins when out of range) of the shifted
        kinematics: the scale ``x * (1 + v)`` in float32."""
        c = theta.shape[0]
        flat = torch.zeros((c, self.kin.shape[1]), dtype=torch.long, device=theta.device)
        valid = torch.ones_like(flat, dtype=torch.bool)
        stride = self.n_bins
        for a, row in enumerate(self.bin_rows):
            x = self.kin[row].expand(c, -1)
            if self.shift is not None and self.shift[1] == row:
                v = theta[:, self.shift[0]].detach().to(torch.float32)
                x = x * (1.0 + v)[:, None]
            e = self.edges[a]
            n_a = len(e) - 1
            stride //= n_a
            idx = torch.searchsorted(e, x.contiguous(), right=True) - 1
            valid &= (idx >= 0) & (idx < n_a)
            flat += idx.clamp(0, n_a - 1) * stride
        return torch.where(valid, flat, self.n_bins)

    def weights(self, theta: torch.Tensor, grids: dict, wdt: torch.dtype) -> torch.Tensor:
        th = theta.to(wdt)
        w = self.mc_weight.to(wdt) * self.prob_table(theta, grids).to(wdt)
        ext = torch.cat([th, torch.ones_like(th[:, :1])], 1)
        for col in self.norm_cols:
            w = w * ext.index_select(1, col)
        knots = self.knots.to(wdt)
        for p, ev, co in self.splines:
            seg, t = spl.segments(knots, th[:, p])
            r = spl.response(co.to(wdt), seg, t)  # [C, n]
            w = w.index_copy(1, ev, w.index_select(1, ev) * r)
        return w

    def nll(self, theta: torch.Tensor, grids: dict, prec: dict) -> torch.Tensor:
        w = self.weights(theta, grids, prec["weights"])
        b = self.bins(theta)
        c = theta.shape[0]
        sd = prec["sums"]
        offs = (torch.arange(c, device=theta.device) * (self.n_bins + 1))[:, None]
        flat = (b + offs).reshape(-1)
        mc = torch.zeros(c * (self.n_bins + 1), dtype=sd, device=theta.device)
        mc = mc.index_add(0, flat, w.reshape(-1).to(sd))
        w2 = torch.zeros_like(mc).index_add(0, flat, (w * w).reshape(-1).to(sd))
        mc = mc.reshape(c, -1)[:, :self.n_bins]
        w2 = w2.reshape(c, -1)[:, :self.n_bins]
        # The statistic's precision is that of its inputs; its arithmetic
        # is float64 (as the configuration's float32 statistic takes it).
        st, f64 = prec["stat"], torch.float64
        per_bin = barlow_beeston(self.data.to(st).to(f64), mc.to(st).to(f64),
                                 w2.to(st).to(f64))
        return per_bin.to(prec["total"]).sum(-1)

    def histogram(self, theta: torch.Tensor, grids: dict) -> torch.Tensor:
        """[C, B] Σw in float64."""
        w = self.weights(theta, grids, torch.float64)
        b = self.bins(theta)
        out = torch.zeros((theta.shape[0], self.n_bins + 1), dtype=torch.float64,
                          device=theta.device)
        return out.scatter_add(1, b, w)[:, :self.n_bins]


def spline_tables(inputs, device="cpu") -> list:
    """Per sample, (θ index, event ids, [n, K-1, 4] float64 coefficients
    at the table precision the configuration states) of every spline
    parameter, made on ``device``."""
    from ..fixtures import KNOT_HIGH, KNOT_LOW, SIGMA_KNOTS

    td = _NAMES[inputs.precision["tables"]]
    return [[(sp.param_index, sp.event_ids,
              spl.coefficients(SIGMA_KNOTS, sp.y_knots, sp.interpolation, KNOT_LOW, KNOT_HIGH, td,
                               device))
             for sp in s.splines] for s in inputs.samples]


class Reference:
    """The reference likelihood of a configuration's inputs on ``device``
    (``tables``: :func:`spline_tables` of the inputs, made once)."""

    def __init__(self, inputs, device, tables: list | None = None):
        self.params = read(inputs.trees)
        self.device = torch.device(device)
        tables = tables if tables is not None else spline_tables(inputs)
        data = inputs.data or [None] * len(inputs.samples)
        self.samples = [_Sample(s, self.params, d, inputs.osc_param_index, list(inputs.nc_modes),
                                t, self.device)
                        for s, d, t in zip(inputs.samples, data, tables)]
        p = self.params
        t = lambda x: torch.as_tensor(x, device=self.device)  # noqa: E731
        self.prefit, self.error = t(p.prefit), t(p.error)
        self.low, self.high = t(p.low), t(p.high)
        self.flat = t(p.flat)
        self.block = t(p.block)
        self.n_blocks = int(p.block.max()) + 1

    def asimov(self, theta: torch.Tensor) -> list[np.ndarray]:
        """Each sample's Σw [B] at one θ [P] (the Asimov data)."""
        grids: dict = {}
        th = theta.to(self.device, torch.float64)[None]
        return [s.histogram(th, grids)[0].cpu().numpy() for s in self.samples]

    def prior(self, theta: torch.Tensor, dt=torch.float64) -> tuple[torch.Tensor, torch.Tensor]:
        """([C] prior -logL, [C] bool at the out-of-bounds sentinel)."""
        th = theta.to(dt)
        pull = torch.where(self.flat, 0.0, (th - self.prefit.to(dt)) / self.error.to(dt))
        out = (theta < self.low) | (theta > self.high)
        n_out = torch.stack([(out & (self.block == b)).sum(1) for b in range(self.n_blocks)], 1)
        per_block = torch.stack([0.5 * (pull * pull * (self.block == b)).sum(1)
                                 for b in range(self.n_blocks)], 1)
        prior = torch.where(n_out > 0, n_out.to(dt) * LARGE_LOGL, per_block).sum(1)
        return prior, n_out.sum(1) > 0

    def nll(self, theta: torch.Tensor, precision: dict | None = None,
            chains_per_block: int = 64) -> torch.Tensor:
        """[C, P] -> [C] total -logL (float64 out), in blocks of chains."""
        prec = precision or F64
        theta = theta.to(self.device, torch.float64)
        block = chains_per_block
        out = []
        for i in range(0, theta.shape[0], block):
            th = theta[i:i + block]
            prior, oob = self.prior(th, prec["total"])
            grids: dict = {}
            samp = sum(s.nll(th, grids, prec) for s in self.samples)
            tot = prior + torch.where(oob, len(self.samples) * LARGE_LOGL, samp)
            out.append(tot.to(torch.float64))
        return torch.cat(out)

    def logp_and_grad(self, theta: torch.Tensor, precision: dict | None = None
                      ) -> tuple[torch.Tensor, torch.Tensor]:
        """[C, P] -> ([C] log-density -(prior + Σ samples), [C, P] its
        gradient), bounds left to the caller, by autograd."""
        prec = precision or F64
        th = theta.to(self.device, torch.float64).detach().requires_grad_(True)
        with torch.enable_grad():
            dt = prec["total"]
            pull = torch.where(self.flat, 0.0, (th.to(dt) - self.prefit.to(dt))
                               / self.error.to(dt))
            grids: dict = {}
            val = -0.5 * (pull * pull).sum(1)
            for s in self.samples:
                val = val - s.nll(th, grids, prec)
            (g,) = torch.autograd.grad(val.sum(), th)
        return val.detach().to(torch.float64), g.to(torch.float64)
