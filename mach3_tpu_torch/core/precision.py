"""Precision policy of the port, taken from ``mach3_tpu/core/precision.py``.

Hot per-event / per-spline arrays are float32; the small reductions whose
results feed the Metropolis decision (the per-bin test-statistic sum, the
Gaussian prior quadratic form) are float64. The card has native float64,
so nothing here needs the TPU package's emulation workarounds.
"""
from __future__ import annotations

import torch

# Hot-path dtype for event weights, spline coefficients, oscillation grids.
FTYPE = torch.float32
# Accumulation dtype for likelihood sums and the proposal/prior linear algebra.
ATYPE = torch.float64
# Index dtype of kernel operands (bins, segments).
ITYPE = torch.int32

#: Sentinel log-likelihood for out-of-bounds proposals
#: (reference ``Manager/Core.h:80`` ``_LARGE_LOGL_ = 1234567890``).
LARGE_LOGL = 1234567890.0

#: Lower bound on MC bin content used by every test statistic
#: (reference ``Manager/Core.h:83`` ``_LOW_MC_BOUND_ = 1e-5``).
LOW_MC_BOUND = 1e-5


def disable_tf32() -> dict[str, bool]:
    """Keep float32 matmuls and convolutions in full float32.

    TF32 keeps ~3 decimal digits: it is the card's form of the TPU trap in
    which f32 dots quietly ran as one bf16 pass. Returns the flags as set."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    return {
        "cuda.matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32,
        "cudnn.allow_tf32": torch.backends.cudnn.allow_tf32,
    }
