"""ChEES-HMC traffic: ``mach3_tpu_torch``'s gradient sampler (``fitters/hmc.py``:
``HMC.run`` with ChEES trajectory adaptation and the dynamic bound, three
replayed CUDA graphs a step, a forward and a backward through the fused
reweight kernels per leapfrog iteration), its chunks' host arrays taken by a
callback.

The check follows the program step by step from its own state: at the
first step of chunks drawn from the seed, the reference takes the step
size, inverse mass and trajectory time of the state (the adaptation is
over before the window), draws the momenta and the accept uniforms from
the chains' generator state, integrates the leapfrog with its own gradient
(autograd of the reference likelihood) and decides. That the adapted
quantities stay as they were through the window is checked by itself."""
from __future__ import annotations

import math
import time

import numpy as np
import torch

from ..compare import pick
from ..reference.params import read
from .mr2t2 import initial_thetas, sync


def halton2(step: int, bits: int = 16) -> float:
    """Base-2 radical inverse of the low ``bits`` bits of ``step``."""
    rev = 0
    for k in range(bits):
        rev |= ((step >> k) & 1) << (bits - 1 - k)
    return rev / float(1 << bits)


class Run:
    rate_metric = "grad_evals_per_s"

    def __init__(self, model, traffic: dict, inputs, seed: int, device):
        from mach3_tpu_torch.fitters.hmc import HMC, HMCConfig

        self.traffic = traffic
        self.cfg = HMCConfig(step_size=traffic["step_size"], adapt_steps=traffic["adapt_steps"],
                             adapt_trajectory=True, max_leapfrog=traffic["max_leapfrog"],
                             chunk_size=traffic["chunk_steps"],
                             target_accept=traffic["target_accept"])
        self.params = read(inputs.trees)
        init = initial_thetas(self.params, traffic["chains"], np.random.default_rng([seed, 1]),
                              traffic["init_jitter"])
        self.fit = HMC(model, self.cfg, init, seed=seed)
        self.chunks: list[dict] = []
        self.snaps: list[dict] = []
        self.stamps: list[float] = []
        self.step0 = 0

    def _snap(self) -> None:
        st = self.fit.state
        self.snaps.append(dict(gen=st.generator.get_state(), log_eps=st.log_eps.clone(),
                               minv=st.minv.clone(), log_traj=st.log_traj.clone()))

    def _callback(self, done, state, host) -> None:
        self.chunks.append(host)
        self.stamps.append(time.perf_counter())
        self._snap()

    def warm_up(self) -> None:
        """The adaptation and the captures, then the state the window
        starts from."""
        warm = self.traffic["warm_steps"]
        if warm <= self.cfg.adapt_steps:
            raise ValueError("the warm-up must end the adaptation before the window")
        self.fit.run(n_steps=warm, collect=False)
        self.step0 = warm
        st = self.fit.state
        self.before = (st.theta.cpu().numpy(), st.logp.cpu().numpy())
        self._snap()

    def window(self, seconds: float) -> dict:
        """Whole chunks until ``seconds`` have passed. The rate counts each
        chain's own gradient evaluations: its trajectory length plus its
        step's start, from the run's outputs."""
        chunk = self.cfg.chunk_size
        sync()
        t0 = time.perf_counter()
        self.stamps.append(t0)
        while time.perf_counter() - t0 < seconds:
            self.fit.run(n_steps=chunk, callback=self._callback, collect=False)
        sync()
        dt = time.perf_counter() - t0
        evals = sum(int((c["n_leapfrog"] + 1).sum()) for c in self.chunks)
        batched = sum(int((c["n_leapfrog"].max(1) + 1).sum()) for c in self.chunks)
        steps = len(self.chunks) * chunk
        n_chains = self.fit.state.theta.shape[0]
        bad = sum(int((~np.isfinite(c["logp"])).sum()) for c in self.chunks)
        return dict(seconds=dt, steps=steps, attempted=steps * n_chains, failed=bad,
                    rate=evals / dt, evals=evals, batched=batched,
                    ms_per_step=1e3 * dt / batched)

    def traced(self, n_steps: int) -> dict:
        out = self.fit.run(n_steps=n_steps, collect=True)
        sync()
        per_step = [int(n) + 1 for n in out["n_leapfrog"].max(1)]
        return dict(steps=n_steps, units=sum(per_step), units_per_step=per_step,
                    theta=out["theta"])

    def release(self) -> None:
        for s in self.snaps:
            for k in ("log_eps", "minv", "log_traj"):
                s[k] = s[k].cpu()
        del self.fit

    # -------------------------------------------------------------- check
    def _follow(self, ref, k: int, prec) -> dict:
        dev, f64 = ref.device, torch.float64
        snap = self.snaps[k]
        theta = torch.as_tensor(self.chunks[k - 1]["theta"][-1] if k else self.before[0],
                                device=dev)
        gen = torch.Generator(device=dev)
        gen.set_state(snap["gen"])
        c, p = theta.shape
        eps = math.exp(float(snap["log_eps"]))
        step = self.step0 + k * self.cfg.chunk_size
        ratio = halton2(step) * math.exp(float(snap["log_traj"])) / eps
        n = int(min(max(math.ceil(ratio), 1), self.cfg.max_leapfrog))
        minv = snap["minv"].to(dev, f64)
        z = torch.randn((c, p), generator=gen, dtype=f64, device=dev)
        mom = z / torch.sqrt(minv)
        ke0 = 0.5 * (minv * mom * mom).sum(1)
        start = theta
        for i in range(n + 1):
            val, g = ref.logp_and_grad(theta, prec)
            if i == 0:
                logp0 = val
            mom = mom + eps * (0.5 if i in (0, n) else 1.0) * g
            if i < n:
                theta = theta + eps * minv * mom
        low = torch.as_tensor(self.params.low, device=dev)
        high = torch.as_tensor(self.params.high, device=dev)
        inside = ((theta >= low) & (theta <= high)).all(1)
        logp_new = torch.where(inside, val, -math.inf)
        ke = 0.5 * (minv * mom * mom).sum(1)
        log_ratio = ((logp_new - ke) - (logp0 - ke0)).clamp(max=0.0)
        log_ratio = torch.where(torch.isnan(log_ratio), -math.inf, log_ratio)
        u = torch.rand((c,), generator=gen, dtype=f64, device=dev)
        accept = torch.log(u) < log_ratio
        return dict(theta=torch.where(accept[:, None], theta, start), accepted=accept,
                    log_u=torch.log(u), log_ratio=log_ratio, n=n,
                    logp=torch.where(accept, logp_new, logp0))

    def check(self, ref, rng: np.random.Generator, n_checks: int, control=None,
              tie: float = 0.0) -> dict:
        from ..reference.likelihood import F64

        dev = ref.device
        sig = torch.as_tensor(self.params.error, device=dev)
        logp_gap = theta_gap = 0.0
        decisions = lengths = 0
        ks = pick(rng, len(self.chunks), n_checks)
        for k in ks:
            r = self._follow(ref, k, F64)
            if control is None:
                row = self.chunks[k]
                got = dict(theta=torch.as_tensor(row["theta"][0], device=dev),
                           logp=torch.as_tensor(row["logp"][0], device=dev),
                           accepted=torch.as_tensor(row["accepted"][0], device=dev),
                           n=int(row["n_leapfrog"][0].max()))
                if int(row["n_leapfrog"][0].min()) != got["n"]:
                    lengths += 1
            else:
                got = self._follow(ref, k, control)
            lengths += int(got["n"] != r["n"])
            anew, _ = ref.logp_and_grad(got["theta"])
            logp_gap = max(logp_gap, float((got["logp"] - anew).abs().max()))
            near = (r["log_u"] - r["log_ratio"]).abs() < tie
            decisions += int(((got["accepted"] != r["accepted"]) & ~near).sum())
            same = got["accepted"] == r["accepted"]
            gap = ((got["theta"] - r["theta"]).abs() / sig).amax(1)[same]
            theta_gap = max(theta_gap, float(gap.max()) if gap.numel() else 0.0)
        first, last = self.snaps[0], self.snaps[-1]
        frozen = max(float((first[key] - last[key]).abs().max())
                     for key in ("log_eps", "minv", "log_traj"))
        return dict(logp_gap=logp_gap, theta_gap=theta_gap, decisions=decisions,
                    lengths=lengths, adapt_frozen=frozen, checked_steps=len(ks))
