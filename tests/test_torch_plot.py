"""Plotting (``mach3_tpu_torch/plotting``, ``cli/plot.py``) vs the JAX
package's: ``mach3-plot-torch`` and ``mach3-plot`` on one ``save_chain``
file and on two for the comparison (``tests/test_cli.py:113-130``), with a
triangle, diagnostics and an LLH scan, write the same set of files;
``InputManager`` / ``FitInput`` and ``StyleManager`` (``tests/test_aux.py:331``)
equal JAX's; the package imports with matplotlib blocked and the CLI then
exits naming it."""
import os
import subprocess
import sys

import numpy as np
import pytest

from mach3_tpu.cli import plot as jcli_plot
from mach3_tpu.plotting import StyleManager as JStyleManager
from mach3_tpu.plotting.inputs import InputManager as JInputManager
from mach3_tpu_torch.cli import plot as cli_plot
from mach3_tpu_torch.diagnostics.chain_io import save_chain
from mach3_tpu_torch.plotting import StyleManager
from mach3_tpu_torch.plotting.inputs import InputManager

NAMES = ["osc_sin2th23", "osc_delta_cp", "xsec_norm_ccqe_C", "flux_0", "det_scale"]
STYLE = ("Style:\n  Palette: ['#112233', '#445566']\n  rcParams: {'font.size': 13}\n"
         "  PrettyNames: {'norm_ccqe_C': 'CCQE (C)'}\n")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("plot")
    rng = np.random.default_rng(3)
    chains = []
    for k in range(2):
        path = str(d / f"chain{k}.npz")
        theta = rng.normal(size=(120, 3, len(NAMES))) * [0.05, 1.0, 0.2, 0.1, 0.02] + k * 0.01
        save_chain(path, {"theta": theta, "nll": rng.normal(size=(120, 3))}, NAMES, "cfg",
                   extra_meta={"prefit": [0.5, 0.0, 1.0, 1.0, 0.0],
                               "prefit_err": [0.1, 2.0, 0.2, 0.1, 0.05]})
        chains.append(path)
    diag = str(d / "diag.npz")
    np.savez(diag, names=np.asarray(NAMES), ess=rng.uniform(50, 500, len(NAMES)),
             split_rhat=rng.uniform(1.0, 1.1, len(NAMES)),
             autocorrelation=rng.uniform(size=(40, len(NAMES))))
    scan = str(d / "scan.npz")
    values = np.linspace(-1, 1, 11)[None].repeat(len(NAMES), 0)
    np.savez(scan, names=np.asarray(NAMES), scan1d_values=values, scan1d_total=values**2,
             scan1d_penalty=0.5 * values**2, scan1d_samples=(values**2)[..., None].repeat(2, -1))
    style = d / "style.yaml"
    style.write_text(STYLE)
    return dict(chains=chains, diag=diag, scan=scan, style=str(style), dir=d)


def _written(main, args, outdir) -> set:
    assert main(args + ["-o", str(outdir)]) == 0
    return set(os.listdir(outdir))


@pytest.mark.parametrize("two", [False, True], ids=["one chain", "comparison"])
def test_cli_writes_what_jax_writes(files, two, tmp_path):
    args = files["chains"][:1 + two] + [
        "--triangle", "osc_sin2th23", "osc_delta_cp", "--diag", files["diag"],
        "--scan", files["scan"], "--style", files["style"]]
    got = _written(cli_plot.main, args, tmp_path / "torch")
    want = _written(jcli_plot.main, args, tmp_path / "jax")
    assert got == want
    assert {"posteriors_1d.png", "violins.png", "correlation.png", "prefit_postfit.png",
            "triangle.png", "diagnostics.png", "llh_scans.png"} <= got
    assert ("posterior_comparison.png" in got) == two


def test_input_manager_equals_jax(files):
    translation = {"Translations": {"Other": {"osc_delta_cp": "dcp"}}}
    ours, theirs = InputManager(translation), JInputManager(translation)
    assert ours.translate("Other", "osc_delta_cp") == theirs.translate("Other", "osc_delta_cp")
    for im in (ours, theirs):
        im.add_chain(files["chains"][0], label="a", fitter="Other", burn_in=0.25)
        im.add_llh_scan(files["scan"], label="s")
    for a, b in zip(ours.inputs, theirs.inputs):
        assert (a.label, a.names) == (b.label, b.names)
        if b.draws is None:
            assert a.draws is None
        else:
            np.testing.assert_array_equal(a.draws, b.draws)
        assert (a.scans is None) == (b.scans is None)
        for k in b.scans or {}:
            np.testing.assert_array_equal(a.scans[k], b.scans[k])
        assert a.index_of(NAMES[1]) == b.index_of(NAMES[1])
    fig = ours.overlay_scans(NAMES[:2])
    assert len(fig.axes) == 2


def test_style_manager_equals_jax(files):
    import matplotlib as mpl

    for cfg in (None, files["style"]):
        ours, theirs = StyleManager(cfg), JStyleManager(cfg)
        assert (ours.palette, ours.rcparams, ours.pretty) == (
            theirs.palette, theirs.rcparams, theirs.pretty)
        for n in NAMES + ["norm_ccqe_C", "xsec_sin2th23"]:
            assert ours.pretty_name(n) == theirs.pretty_name(n)
        assert [ours.color(i) for i in range(10)] == [theirs.color(i) for i in range(10)]
    before = mpl.rcParams["font.size"]
    with StyleManager(files["style"]).context():
        assert mpl.rcParams["font.size"] == 13
        assert mpl.rcParams["axes.prop_cycle"].by_key()["color"][0] == "#112233"
    assert mpl.rcParams["font.size"] == before


_BLOCKED = """
import sys
sys.modules["matplotlib"] = None
sys.modules["jax"] = None
import mach3_tpu_torch.plotting
from mach3_tpu_torch.plotting.plots import plot_violins
from mach3_tpu_torch.cli import plot
try:
    plot_violins(None)
except ImportError as err:
    print("plots:", err)
try:
    plot.main([sys.argv[1]])
except SystemExit as err:
    print("cli:", err)
"""


def test_imports_without_matplotlib(files):
    out = subprocess.run([sys.executable, "-c", _BLOCKED, files["chains"][0]],
                         capture_output=True, text=True, timeout=120,
                         cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert len(lines) == 2 and all("matplotlib" in ln for ln in lines), lines
