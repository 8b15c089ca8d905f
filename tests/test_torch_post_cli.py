"""The port's post-processing CLIs (``mach3-diag-torch``, ``-process-``,
``-rhat-``, ``-combine-`` and ``-predictive-torch``) against the JAX
package's CLIs on the same chain files and seed, with ``--device cpu``; and
all five in a subprocess with jax blocked, as on the card's machine.

The chain files are written by the port's ``save_chain``: draws around the
toy's prefit with the toy's parameter names, two files of two chains each.
Outputs: the npz keys equal; diag's arrays within 1e-10 relative (the
autocorrelation family in torch f64, R-hat in numpy, against ``jnp``); process's,
rhat's (its printed table) and combine's equal (numpy on both sides); the
predictive's toys equal (the same numpy draws), spectra within the
histogram budget 2e-3 and ``llh_data`` within 5e-3 + 1e-3·|NLL|.
"""
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from mach3_tpu.cli import combine as jcombine
from mach3_tpu.cli import diag as jdiag
from mach3_tpu.cli import predictive as jpredictive_cli
from mach3_tpu.cli import process as jprocess
from mach3_tpu.cli import rhat as jrhat
from mach3_tpu.diagnostics.predictive import draw_parameter_sets as jdraw
from mach3_tpu_torch.cli import combine, diag, predictive, process, rhat
from mach3_tpu_torch.diagnostics.chain_io import load_chain, save_chain
from mach3_tpu_torch.diagnostics.predictive import draw_parameter_sets
from mach3_tpu_torch.tutorial.toy import build_toy

torch.set_num_threads(1)

CPU = ["--device", "cpu"]
N_EVENTS = 2000
HIST_BUDGET = 2e-3
NLL_ATOL, NLL_RTOL = 5e-3, 1e-3


@pytest.fixture(scope="module")
def chains(tmp_path_factory):
    """Two chain files [300 steps, 2 chains, 16 params] of AR(1) draws
    around the toy's prefit (0.2 prior widths), the second one offset in
    sin²θ23."""
    d = tmp_path_factory.mktemp("chains")
    toy = build_toy(n_events=N_EVENTS, device="cpu")
    flat = toy.model.flat
    prefit = flat.prefit.numpy()
    sig = np.sqrt(np.diag((flat.chol @ flat.chol.T).numpy()))
    rng = np.random.default_rng(0)
    paths = []
    for k in range(2):
        z = np.zeros((300, 2, len(prefit)))
        e = rng.normal(size=z.shape)
        for t in range(1, 300):
            z[t] = 0.8 * z[t - 1] + 0.6 * e[t]
        theta = prefit + 0.2 * sig * z
        theta[..., toy.names.index("osc_sin2th23")] += 0.002 * k
        path = str(d / f"chain_{k}.npz")
        save_chain(path, {"theta": theta, "nll": rng.random((300, 2))}, toy.names,
                   config_yaml="toy: {}")
        paths.append(path)
    return d, paths


def _npz(path):
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


def test_diag_matches_jax(chains, capsys):
    d, (a, _) = chains
    assert diag.main([a, "-o", str(d / "diag_t.npz"), "--max-lag", "60", *CPU]) == 0
    assert jdiag.main([a, "-o", str(d / "diag_j.npz"), "--max-lag", "60"]) == 0
    t, j = _npz(d / "diag_t.npz"), _npz(d / "diag_j.npz")
    assert t.keys() == j.keys()
    np.testing.assert_array_equal(t["names"], j["names"])
    for k in ("split_rhat", "folded_rhat", "ess", "geweke", "batched_means_ratio",
              "autocorrelation"):
        np.testing.assert_allclose(t[k], j[k], rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("extra", [[], ["--jarlskog", "--smear", "xsec_spl_maqe=0.05",
                                        "--reweight-prior", "osc_sin2th23", "0.55", "0.02",
                                        "--thin", "2", "--credible", "0.5", "0.9"]],
                         ids=["plain", "jarlskog-smear-reweight"])
def test_process_matches_jax(chains, capsys, extra):
    d, (a, _) = chains
    assert process.main([a, "-o", str(d / "proc_t.npz"), "--seed", "4", *extra, *CPU]) == 0
    out_t = capsys.readouterr().out
    assert jprocess.main([a, "-o", str(d / "proc_j.npz"), "--seed", "4", *extra]) == 0
    out_j = capsys.readouterr().out
    assert out_t.replace(str(d / "proc_t.npz"), "") == out_j.replace(str(d / "proc_j.npz"), "")
    t, j = _npz(d / "proc_t.npz"), _npz(d / "proc_j.npz")
    assert t.keys() == j.keys()
    for k in t:
        np.testing.assert_array_equal(t[k], j[k], k)
    if "--jarlskog" in extra:
        assert "P(normal ordering)" in out_t


@pytest.mark.parametrize("folded", [False, True], ids=["plain", "folded"])
def test_rhat_matches_jax(chains, capsys, folded):
    _, paths = chains
    opt = ["--folded"] if folded else []
    assert rhat.main([*paths, "--burn-in", "0.1", *opt, *CPU]) == 0
    out_t = capsys.readouterr().out
    assert jrhat.main([*paths, "--burn-in", "0.1", *opt]) == 0
    assert out_t == capsys.readouterr().out
    assert "4 chains x 270 steps" in out_t


def test_combine_matches_jax(chains):
    d, paths = chains
    assert combine.main([*paths, "-o", str(d / "comb_t.npz"), *CPU]) == 0
    assert jcombine.main([*paths, "-o", str(d / "comb_j.npz")]) == 0
    (dt, mt, _), (dj, mj, _) = load_chain(str(d / "comb_t.npz")), load_chain(str(d / "comb_j.npz"))
    assert dt.keys() == dj.keys() and mt == mj
    for k in dt:
        np.testing.assert_array_equal(dt[k], dj[k])
    assert dt["theta"].shape == (600, 2, 16)


def test_predictive_matches_jax(chains):
    """40 toys of the 2,000-event toy with its interaction modes: the JAX CLI
    (one vmapped chunk, XLA) and the port's (toys on the chain axis)."""
    d, (a, _) = chains
    common = [a, "--toys", "40", "--n-events", str(N_EVENTS), "--seed", "5"]
    assert predictive.main([*common, "-o", str(d / "pred_t.npz"), *CPU]) == 0
    assert jpredictive_cli.main([*common, "-o", str(d / "pred_j.npz")]) == 0
    t, j = _npz(d / "pred_t.npz"), _npz(d / "pred_j.npz")
    assert t.keys() == j.keys()
    theta = load_chain(a)[0]["theta"]
    np.testing.assert_array_equal(draw_parameter_sets(theta, 40, np.random.default_rng(5)),
                                  jdraw(theta, 40, np.random.default_rng(5)))
    for k in t:
        if k.startswith(("spectra_", "by_mode_", "data_")):
            tol = HIST_BUDGET * np.abs(j[k]) + 1e-6 * np.abs(j[k]).max()
            assert np.all(np.abs(t[k] - j[k]) <= tol), k
    gap = np.abs(t["llh_data"] - j["llh_data"])
    assert np.all(gap <= NLL_ATOL + NLL_RTOL * np.abs(j["llh_data"]))
    assert t["by_mode_numu_sample"].shape == j["by_mode_numu_sample"].shape


_BLOCKED = """
import sys
sys.modules["jax"] = None  # any `import jax` now raises ImportError
from mach3_tpu_torch.cli import combine, diag, predictive, process, rhat
d, a, b = sys.argv[1], sys.argv[2], sys.argv[3]
cpu = ["--device", "cpu"]
codes = [
    diag.main([a, "-o", d + "/b_diag.npz", *cpu]),
    process.main([a, "--jarlskog", "-o", d + "/b_proc.npz", *cpu]),
    rhat.main([a, b, *cpu]),
    combine.main([a, b, "-o", d + "/b_comb.npz", *cpu]),
    predictive.main([a, "--toys", "20", "--n-events", "1500", "-o", d + "/b_pred.npz", *cpu]),
]
assert not any(k == "mach3_tpu" or k.startswith("mach3_tpu.") for k in sys.modules)
print("codes", codes)
"""


def test_clis_run_with_jax_blocked(chains):
    d, (a, b) = chains
    out = subprocess.run([sys.executable, "-c", _BLOCKED, str(d), a, b], capture_output=True,
                         text=True, timeout=300, cwd=pathlib.Path(__file__).resolve().parent.parent)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "codes [0, 0, 0, 0, 0]" in out.stdout
    for name in ("b_diag", "b_proc", "b_comb", "b_pred"):
        assert (d / f"{name}.npz").exists()


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal without a card")
@pytest.mark.parametrize("cli", [diag, process, rhat, combine, predictive],
                         ids=["diag", "process", "rhat", "combine", "predictive"])
def test_default_device_needs_a_card(chains, cli):
    """``--device`` defaults to cuda: without a card every CLI stops before
    any work instead of running on the CPU."""
    d, (a, b) = chains
    argv = {combine: [a, b, "-o", str(d / "x.npz")], rhat: [a, b]}.get(cli, [a])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(argv)
