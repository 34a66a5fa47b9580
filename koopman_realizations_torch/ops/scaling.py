"""Affine [-1,1] data scaling (port of ``ops/scaling.py`` of the JAX
package: ``Scaler``, ``fit_scaler``).

scaledown: (v - offset) / factor ; scaleup: v * factor + offset, over the
LAST axis as in the JAX package.  Works on numpy arrays and on torch
tensors (the factors follow the tensor's dtype and device); lanes-minor
callers pass ``axis=0``.  Fitting and whole-trial scaling are host numpy
f64, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from koopman_realizations_torch.types import Trial


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

    def trial_down(self, tr: Trial) -> Trial:
        """A trial in scaled space, host numpy f64 (x and w only where
        both the trial and the scaler have them)."""
        def f(v, fac, off):
            return (np.asarray(v) - np.asarray(off)) / np.asarray(fac)
        return Trial(
            t=tr.t,
            y=f(tr.y, self.y_factor, self.y_offset),
            u=f(tr.u, self.u_factor, self.u_offset),
            x=None if (tr.x is None or self.x_factor is None)
            else f(tr.x, self.x_factor, self.x_offset),
            w=None if (tr.w is None or self.w_factor is None)
            else f(tr.w, self.w_factor, self.w_offset))


def _fit_range(v: np.ndarray):
    vmin, vmax = v.min(axis=0), v.max(axis=0)
    offset = (vmax + vmin) / 2.0
    factor = (vmax - vmin) / 2.0
    return np.where(factor == 0.0, 1.0, factor), offset


def fit_scaler(train: Trial) -> Scaler:
    """The scaler of merged training data (``Ksysid.get_scale:180-285``):
    zero-range dimensions keep factor 1 (``Ksysid.m:198-204``); constant
    load dimensions are only shifted (``Ksysid.m:251-260``)."""
    yf, yo = _fit_range(np.asarray(train.y))
    uf, uo = _fit_range(np.asarray(train.u))
    kw = dict(y_factor=yf, y_offset=yo, u_factor=uf, u_offset=uo)
    if train.x is not None:
        xf, xo = _fit_range(np.asarray(train.x))
        kw.update(x_factor=xf, x_offset=xo)
    if train.w is not None:
        w = np.asarray(train.w)
        wmin, wmax = w.min(axis=0), w.max(axis=0)
        kw.update(w_factor=np.where(wmin == wmax, 1.0, (wmax - wmin) / 2.0),
                  w_offset=(wmax + wmin) / 2.0)
    return Scaler(**kw)
