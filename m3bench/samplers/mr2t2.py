"""MR2T2 traffic: the production sampler of ``mach3_tpu_torch``
(``fitters/mcmc.py``: ``MR2T2.run`` in chunks, each a replayed CUDA graph,
pooled adaptive Metropolis with Robbins-Monro), its chunks' host arrays
taken by a callback as ``mach3-mcmc-torch`` takes them.

The check follows the program step by step from its own state: at the
first step of chunks drawn from the seed, the reference draws what the step
draws from the chains' generator state (the proposal's normals and flip
uniforms, the accept uniforms), throws from the adapted factor and scale
of the state, evaluates the proposal and the current point and decides.
The stage this takes from the program, the adaptive moments and the throw
matrix, is checked by itself: one chunk's moments, scale and factor are
worked out again from its draws."""
from __future__ import annotations

import time

import numpy as np
import torch

from ..compare import circular_wrap, pick
from ..reference.likelihood import LARGE_LOGL
from ..reference.params import read

HAARIO_SCALE = 5.6644  # 2.38²
#: The first window chunks kept whole; the moments check draws one.
MOMENT_CHUNKS = 4


def sync() -> None:
    """Wait for the card (a no-op without one)."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def initial_thetas(params, n_chains: int, rng: np.random.Generator, jitter: float) -> np.ndarray:
    """The prefit point plus ``jitter`` prior widths of noise, inside the bounds."""
    init = params.prefit + jitter * params.error * rng.normal(size=(n_chains, len(params.prefit)))
    eps = 1e-6 * (params.high - params.low)
    return np.clip(init, params.low + eps, params.high - eps)


class Run:
    """One cell's sampler: set-up, window, trace, check."""

    rate_metric = "chain_steps_per_s"

    def __init__(self, model, traffic: dict, inputs, seed: int, device):
        from mach3_tpu_torch.fitters.mcmc import MR2T2, MCMCConfig

        self.traffic = traffic
        self.cfg = MCMCConfig(
            chunk_size=traffic["chunk_steps"], adaptive=True,
            adaption_mode=traffic["adaption_mode"],
            adaption_start_update=traffic["adaption_start_update"],
            adaption_start_throw=traffic["adaption_start_throw"],
            adaption_update_step=traffic["adaption_update_step"],
            target_accept=traffic["target_accept"])
        self.params = read(inputs.trees)
        init = initial_thetas(self.params, traffic["chains"], np.random.default_rng([seed, 1]),
                              traffic["init_jitter"])
        self.fit = MR2T2(model, self.cfg, init, seed=seed)
        self.start = (init, self.fit.state.nll.cpu().numpy())
        self.chunks: list[dict] = []
        self.snaps: list[dict] = []
        self.stamps: list[float] = []
        self.step0 = 0

    # ------------------------------------------------------------ running
    def _snap(self) -> None:
        st, ad = self.fit.state, self.fit.state.adaptive
        self.snaps.append(dict(gen=st.generator.get_state(), chol=ad.chol.clone(),
                               log_scale=ad.log_scale.clone(), mean=ad.mean.clone(),
                               cov=ad.cov.clone(), n=ad.n_updates.clone()))

    def _callback(self, done, state, host) -> None:
        """Keep what the check needs: each chunk's first step, last state and
        mean acceptance per step; the first chunks whole (the moments
        check draws one of them)."""
        keep = {k: v[0] for k, v in host.items()}
        keep.update(last_theta=host["theta"][-1], acc_mean=host["acc_prob"].mean(1),
                    bad=int((~np.isfinite(host["nll"])).sum()))
        if len(self.chunks) < MOMENT_CHUNKS:
            keep["rows"] = {"theta": host["theta"], "acc_prob": host["acc_prob"]}
        self.chunks.append(keep)
        self.stamps.append(time.perf_counter())
        self._snap()

    def warm_up(self) -> None:
        """The traffic's warm-up steps (the graph's capture among them),
        then the state the window starts from."""
        self.fit.run(n_steps=self.traffic["warm_steps"], collect=False)
        self.step0 = self.traffic["warm_steps"]
        st = self.fit.state
        self.before = (st.theta.cpu().numpy(), st.nll.cpu().numpy())
        self._snap()

    def window(self, seconds: float) -> dict:
        """Whole chunks until ``seconds`` have passed; the rate over all of
        them, each chunk's copy to the host included."""
        chunk = self.cfg.chunk_size
        sync()
        t0 = time.perf_counter()
        self.stamps.append(t0)
        while time.perf_counter() - t0 < seconds:
            self.fit.run(n_steps=chunk, callback=self._callback, collect=False)
        sync()
        dt = time.perf_counter() - t0
        steps = len(self.chunks) * chunk
        n_chains = self.fit.state.theta.shape[0]
        bad = sum(c["bad"] for c in self.chunks)
        return dict(seconds=dt, steps=steps, attempted=steps * n_chains, failed=bad,
                    rate=steps * n_chains / dt, ms_per_step=1e3 * dt / steps)

    def traced(self, n_steps: int) -> dict:
        """``n_steps`` more steps (to be traced): their draws."""
        out = self.fit.run(n_steps=n_steps, collect=True)
        sync()
        return dict(steps=n_steps, units=n_steps, theta=out["theta"])

    def release(self) -> None:
        """Free the program's state; keep the host records."""
        for s in self.snaps:
            for k in ("chol", "log_scale", "mean", "cov", "n"):
                s[k] = s[k].cpu()
        del self.fit

    # -------------------------------------------------------------- check
    def _follow(self, ref, k: int, prec, chains: np.ndarray) -> dict:
        """The first step of window chunk ``k`` from the state before it,
        by the reference at precision ``prec``, for the chains ``chains``."""
        dev = ref.device
        f64 = torch.float64
        snap = self.snaps[k]
        theta_prev = torch.as_tensor(self.chunks[k - 1]["last_theta"] if k else self.before[0],
                                     device=dev)
        gen = torch.Generator(device=dev)
        gen.set_state(snap["gen"])
        c, p = theta_prev.shape
        z = torch.randn((c, p), generator=gen, dtype=f64, device=dev)
        torch.rand((c, p), generator=gen, dtype=f64, device=dev)  # flip uniforms: no flips
        dt = prec["total"]
        chol, scale = snap["chol"].to(dev), torch.exp(snap["log_scale"].to(dev))
        prop = (theta_prev.to(dt) + scale.to(dt) * (z.to(dt) @ chol.to(dt).T)).to(f64)
        circ = torch.as_tensor(self.params.circ, device=dev)
        lo = torch.as_tensor(self.params.circ_low, device=dev)
        hi = torch.as_tensor(self.params.circ_high, device=dev)
        prop = torch.where(circ, circular_wrap(prop, lo, hi), prop)
        u = torch.rand((c,), generator=gen, dtype=f64, device=dev)
        rows = torch.as_tensor(chains, device=dev)
        prop, theta_prev, u = prop[rows], theta_prev[rows], u[rows]
        nll_prop = ref.nll(prop, prec)
        nll_prev = ref.nll(theta_prev, prec)
        acc = torch.exp((nll_prev - nll_prop).clamp(max=0.0))
        accept = (nll_prop < LARGE_LOGL) & (u < acc)
        return dict(theta=torch.where(accept[:, None], prop, theta_prev),
                    nll=torch.where(accept, nll_prop, nll_prev), acc=acc, accepted=accept,
                    log_u=torch.log(u))

    def _moments(self, k: int, dt) -> dict:
        """Window chunk ``k``'s adaptive moments, scale and throw factor,
        worked out again from its draws from the state before it."""
        cfg = self.cfg
        s0 = self.snaps[k]
        mean, cov = s0["mean"].to(dt), s0["cov"].to(dt)
        n, log_s = int(s0["n"]), s0["log_scale"].to(dt)
        chol = s0["chol"].to(dt)
        rows = self.chunks[k]["rows"]
        d = cov.shape[0]
        for i in range(len(rows["theta"])):
            step = self.step0 + k * cfg.chunk_size + i + 1
            th = torch.as_tensor(rows["theta"][i]).to(dt)
            if cfg.adaption_start_update <= step <= cfg.adaption_end_update:
                x, xxt = th.mean(0), th.T @ th / th.shape[0]
                new_mean = (x + mean * n) / (n + 1.0)
                if n > 0:
                    cov = (cov * (n - 1.0) / n
                           + (n * torch.outer(mean, mean) - (n + 1.0) * torch.outer(new_mean, new_mean)
                              + xxt) / n)
                mean, n = new_mean, n + 1
            gamma = 2.0 / max(step, 1) ** 0.66
            acc = float(np.mean(rows["acc_prob"][i]))
            log_s = (log_s + gamma * (acc - cfg.target_accept)).clamp(-8.0, 4.0)
            if step >= cfg.adaption_start_throw and \
                    (step - cfg.adaption_start_throw) % cfg.adaption_update_step == 0:
                chol, info = torch.linalg.cholesky_ex(cov * (HAARIO_SCALE / d)
                                                      + 1e-12 * torch.eye(d, dtype=dt))
                if int(info):  # no factor: NaN, as the sampler has it
                    chol = torch.full_like(chol, torch.nan)
        return dict(mean=mean, cov=cov, log_scale=log_s, chol=chol)

    def check(self, ref, rng: np.random.Generator, n_checks: int, control=None,
              tie: float = 0.0) -> dict:
        """The numbers compared: the program's (or, with ``control``, the
        reference at that precision in its place) against the reference."""
        from ..reference.likelihood import F64

        dev = ref.device
        sig = torch.as_tensor(self.params.error, device=dev)
        nll_gap = theta_gap = 0.0
        decisions = 0
        th0, nll0 = (torch.as_tensor(x, device=dev) for x in self.start)
        if control is None:
            nll_gap = float((nll0 - ref.nll(th0)).abs().max())
        ks = pick(rng, len(self.chunks), n_checks)
        n_chains = len(self.before[0])
        chains = np.sort(rng.choice(n_chains, size=min(n_chains, self.traffic["check_chains"]),
                                    replace=False))
        for k in ks:
            r = self._follow(ref, k, F64, chains)
            if control is None:
                row = self.chunks[k]
                got = {key: torch.as_tensor(row[key][chains], device=dev)
                       for key in ("theta", "nll", "accepted")}
            else:
                got = self._follow(ref, k, control, chains)
            anew = ref.nll(got["theta"])
            ok = got["nll"] < LARGE_LOGL
            gaps = (got["nll"] - anew).abs()[ok]
            nll_gap = max(nll_gap, float(gaps.max()) if gaps.numel() else 0.0)
            # A near-tie: log u within ``tie`` of log α, where either side
            # may round the other way.
            near = (r["log_u"] - torch.log(r["acc"])).abs() < tie
            differ = (got["accepted"] != r["accepted"]) & ~near
            decisions += int(differ.sum())
            same = got["accepted"] == r["accepted"]
            gap = ((got["theta"] - r["theta"]).abs() / sig).amax(1)[same]
            theta_gap = max(theta_gap, float(gap.max()) if gap.numel() else 0.0)
        k = min(int(rng.integers(MOMENT_CHUNKS)), len(self.chunks) - 1)
        want = self._moments(k, torch.float64)
        if control is None:
            have = {key: self.snaps[k + 1][key].to(torch.float64)
                    for key in ("mean", "cov", "log_scale", "chol")}
        else:
            have = {key: v.to(torch.float64) for key, v in
                    self._moments(k, control["total"]).items()}
        adapt_gap = max(float((have[key] - want[key]).abs().max()
                              / max(float(want[key].abs().max()), 1e-300))
                        for key in ("mean", "cov", "chol"))
        adapt_gap = max(adapt_gap, float((have["log_scale"] - want["log_scale"]).abs()))
        return dict(nll_gap=nll_gap, theta_gap=theta_gap, decisions=decisions,
                    adapt_gap=adapt_gap, checked_steps=len(ks))
