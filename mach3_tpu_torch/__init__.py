"""mach3_tpu_torch — the PyTorch/CUDA port of ``mach3_tpu``.

The JAX package ``mach3_tpu`` stays the reference; this package mirrors its
module names so each module's counterpart is easy to find:

* ``core``      — precision policy, config (YAML), logging, special functions
* ``params``    — parameter sets, prior model, correlated proposals
* ``splines``   — spline coefficients, dense monolith, eval, the shared
  route's event layout (``splines/plan.py``), the fused reweight-histogram
  kernel wrappers (``splines/reweight.py``)
* ``osc``       — 3-flavour oscillation probabilities: beam (constant
  density) and atmospheric (layered PREM earth)
* ``samples``   — event store, binning, routing, reweighting, test statistics
* ``fitters``   — the fit model and the fixed-proposal MR2T2 sampler
* ``tutorial``  — the two-sample toy and the reference-scale fixture
* ``kernels``   — builds the hand-written CUDA kernels in ``csrc/``
* ``bridge``    — turns a JAX ``FitModel`` into this package's ``FitModel``

Models are ``nn.Module``s whose static arrays are registered buffers, so one
``.to(device)`` moves a model. This package imports ``torch`` and never jax.
"""

__version__ = "0.1.0"
