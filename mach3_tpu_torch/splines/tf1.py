"""TF1 (linear functional) systematic responses (port of
``mach3_tpu/splines/tf1.py``).

The reference's ``TF1_red`` (``Splines/SplineStructs.h:148-214``) gives each
(event, parameter) a linear response ``intercept + slope * v``, evaluated on
the GPU by ``EvalOnGPU_TF1`` (``Splines/gpuSplineUtils.cu:386-408``). Here
the ragged list becomes two dense [Pt, E] tables (slope 0 and intercept 1
for an event a parameter does not touch), and the evaluation is a few
elementwise ops in the base weight.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch
from torch import nn

from ..core.logging import get_logger
from ..core.precision import FTYPE

_log = get_logger("splines")


@dataclasses.dataclass
class TF1ParamSpec:
    """One TF1 systematic before flattening: event ``event_ids[i]`` gets the
    response ``intercept[i] + slope[i] * v``, v the value of parameter
    ``param_index``; other events respond with 1."""

    name: str
    param_index: int  # index into the proposed-parameter vector
    event_ids: np.ndarray  # [S_p]
    slope: np.ndarray  # [S_p] (the reference's Par[0])
    intercept: np.ndarray  # [S_p] (the reference's Par[1])


class TF1Table(nn.Module):
    """Buffers: slope [Pt, E] f32 (0 off the matched events), intercept
    [Pt, E] f32 (1 there), param_index [Pt] i64 into the proposal vector."""

    def __init__(self, slope, intercept, param_index):
        super().__init__()
        self.register_buffer("slope", torch.as_tensor(slope, dtype=FTYPE))
        self.register_buffer("intercept", torch.as_tensor(intercept, dtype=FTYPE))
        self.register_buffer("param_index", torch.as_tensor(param_index, dtype=torch.long))

    @property
    def n_tf1_params(self) -> int:
        return self.slope.shape[0]

    @property
    def n_events(self) -> int:
        return self.slope.shape[1]

    def eval(self, thetas: torch.Tensor) -> torch.Tensor:
        """Per-event product of the responses, each floored at 0 (a negative
        event weight is unphysical): thetas [C, NP] -> [C, E] f32. The
        value is rounded to f32 first, as the JAX package does."""
        v = thetas[:, self.param_index].to(FTYPE)
        w = None
        for p in range(self.n_tf1_params):
            resp = (self.intercept[p] + self.slope[p] * v[:, p, None]).clamp(min=0.0)
            w = resp if w is None else w * resp
        return w

    def take_events(self, perm, pad_mask=None) -> "TF1Table":
        """The same table for the events ``perm`` (a reorder and/or copies);
        the events of ``pad_mask`` respond with 1."""
        perm = torch.as_tensor(perm, dtype=torch.long)
        slope, intercept = self.slope[:, perm], self.intercept[:, perm]
        if pad_mask is not None:
            pad = torch.as_tensor(pad_mask, dtype=torch.bool)
            slope[:, pad] = 0.0
            intercept[:, pad] = 1.0
        return TF1Table(slope, intercept, self.param_index)


def build_tf1_table(specs: Sequence[TF1ParamSpec], n_events: int) -> TF1Table:
    """The dense [Pt, E] table of ``specs``."""
    slope = np.zeros((len(specs), n_events), np.float32)
    intercept = np.ones((len(specs), n_events), np.float32)
    for p, spec in enumerate(specs):
        ev = np.asarray(spec.event_ids, np.int64)
        slope[p, ev] = np.asarray(spec.slope, np.float32)
        intercept[p, ev] = np.asarray(spec.intercept, np.float32)
    _log.info("TF1 table: %d params x %d events (%d matched responses, %.1f MB)",
              len(specs), n_events, sum(len(s.event_ids) for s in specs),
              (slope.nbytes + intercept.nbytes) / 1e6)
    return TF1Table(slope, intercept, [s.param_index for s in specs])
