"""Affine [-1,1] data scaling (port of ``ops/scaling.py:Scaler``).

scaledown: (v - offset) / factor ; scaleup: v * factor + offset, over the
LAST axis as in the JAX package.  Works on numpy arrays and on torch
tensors (the factors follow the tensor's dtype and device); lanes-minor
callers pass ``axis=0``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch


def _coef(v, c, axis: int):
    """(d,) coefficients as v's array type, broadcast along ``axis``."""
    c = np.asarray(c)
    if isinstance(v, torch.Tensor):
        c = torch.as_tensor(c, dtype=v.dtype, device=v.device)
    if axis == 0 and v.ndim > 1:
        c = c.reshape((-1,) + (1,) * (v.ndim - 1))
    return c


def _down(v, off, fac, axis):
    v = v if isinstance(v, torch.Tensor) else np.asarray(v)
    return (v - _coef(v, off, axis)) / _coef(v, fac, axis)


def _up(v, fac, off, axis):
    v = v if isinstance(v, torch.Tensor) else np.asarray(v)
    return v * _coef(v, fac, axis) + _coef(v, off, axis)


@dataclasses.dataclass(frozen=True, eq=False)
class Scaler:
    """Per-dimension affine maps fitted from the training data (f64)."""

    y_factor: Any
    y_offset: Any
    u_factor: Any
    u_offset: Any
    x_factor: Optional[Any] = None
    x_offset: Optional[Any] = None
    w_factor: Optional[Any] = None
    w_offset: Optional[Any] = None

    def y_down(self, y, axis: int = -1):
        return _down(y, self.y_offset, self.y_factor, axis)

    def y_up(self, y, axis: int = -1):
        return _up(y, self.y_factor, self.y_offset, axis)

    def u_down(self, u, axis: int = -1):
        return _down(u, self.u_offset, self.u_factor, axis)

    def u_up(self, u, axis: int = -1):
        return _up(u, self.u_factor, self.u_offset, axis)

    def ref_down(self, ref, proj_idx, axis: int = -1):
        idx = list(proj_idx)
        return _down(ref, np.asarray(self.y_offset)[idx],
                     np.asarray(self.y_factor)[idx], axis)

    def ref_up(self, ref, proj_idx, axis: int = -1):
        idx = list(proj_idx)
        return _up(ref, np.asarray(self.y_factor)[idx],
                   np.asarray(self.y_offset)[idx], axis)
