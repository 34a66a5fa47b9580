"""Model-class comparison over a random-system ensemble (port of
``workflows/rand_models.py`` of the JAX package; the reference's
``evaluate_rand_models.m``).

The reference trains 13 linear + 6 bilinear + 4 nonlinear models for
each of ~20 scalar systems one at a time (460 ``Ksysid`` fits).  Here
every (family, degree) configuration trains all systems at once: the
snapshot pairing, lifting, the Gram least squares (or the nonlinear
family's FISTA lasso), the model extraction and the validation rollout
batch over the system axis on the device, 23 configurations in all.

The error is ``evaluate_rand_models.m:69-75``'s: the mean absolute
validation error over the mean |y| of the trial.  The dtype is explicit
and defaults to f64, the JAX reference's x64 and the rule that the
regression runs in f64.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from koopman_realizations_torch import resolve_device
from koopman_realizations_torch.models.rsys import ipow
from koopman_realizations_torch.ops.lasso import lasso_constrained_lstsq
from koopman_realizations_torch.ops.lstsq import gram_lstsq, ridge_for_dtype
from koopman_realizations_torch.types import DataSet


def _stack_ensemble(datasets: List[DataSet]):
    """Per-system train/validation arrays (the systems share trial
    shapes): (Ytr [S,R,T], Utr [S,R,T], Yval [S,Tv], Uval [S,Tv]) as host
    numpy.  Scalar systems only (n = m = 1), like the reference's."""
    Ytr = np.stack([[np.asarray(tr.y)[:, 0] for tr in ds.train]
                    for ds in datasets])
    Utr = np.stack([[np.asarray(tr.u)[:, 0] for tr in ds.train]
                    for ds in datasets])
    Yval = np.stack([np.asarray(ds.val[0].y)[:, 0] for ds in datasets])
    Uval = np.stack([np.asarray(ds.val[0].u)[:, 0] for ds in datasets])
    return Ytr, Utr, Yval, Uval


def _scale_params(Ytr, Utr):
    """Per-system [-1, 1] scaling factors and offsets of the merged
    training data (host numpy)."""
    y_off = (Ytr.max(axis=(1, 2)) + Ytr.min(axis=(1, 2))) / 2
    y_fac = (Ytr.max(axis=(1, 2)) - Ytr.min(axis=(1, 2))) / 2
    u_off = (Utr.max(axis=(1, 2)) + Utr.min(axis=(1, 2))) / 2
    u_fac = (Utr.max(axis=(1, 2)) - Utr.min(axis=(1, 2))) / 2
    y_fac = np.where(y_fac == 0, 1.0, y_fac)
    u_fac = np.where(u_fac == 0, 1.0, u_fac)
    return y_fac, y_off, u_fac, u_off


def _poly1d(x: torch.Tensor, degree: int) -> torch.Tensor:
    """[x, x^2, ..., x^degree, 1] stacked on a new LAST axis: the scalar
    poly basis with its trailing 1."""
    return torch.stack([ipow(x, k) for k in range(1, degree + 1)]
                       + [torch.ones_like(x)], dim=-1)


def _rows(x, u, degree: int, family: str):
    """The regression rows of a family at states x and inputs u (any
    shape): (..., cols).  linear [g(x), u]; bilinear [g(x), u g(x)];
    nonlinear x^i u^j for 1 <= i + j <= degree, then the constant."""
    if family == "linear":
        return torch.cat([_poly1d(x, degree), u[..., None]], dim=-1)
    if family == "bilinear":
        g = _poly1d(x, degree)
        return torch.cat([g, u[..., None] * g], dim=-1)
    feats = [ipow(x, i) * ipow(u, j)
             for tot in range(1, degree + 1)
             for i, j in [(tot - k, k) for k in range(tot + 1)]]
    feats.append(torch.ones_like(x))
    return torch.stack(feats, dim=-1)


def _fit_and_val(Ytr, Utr, Yval, Uval, degree: int, family: str,
                 lasso: float = np.inf, lasso_iters: int = 500):
    """Train and validate one (family, degree) configuration for every
    system at once (``_fit_and_val``, JAX ``rand_models.py:55-167``).

    Ytr/Utr (S, R, T) scaled training trials, Yval/Uval (S, Tv) scaled
    validation trials, tensors on one device.  Returns the normed mean
    validation error per system (S,) on that device."""
    S = Ytr.shape[0]
    # snapshot pairs within each trial; the final merged pair is dropped,
    # as the production trainer's P-1 subsample does (Ksysid.m:973-975)
    a = Ytr[:, :, :-1].reshape(S, -1)[:, :-1]
    b = Ytr[:, :, 1:].reshape(S, -1)[:, :-1]
    u = Utr[:, :, :-1].reshape(S, -1)[:, :-1]
    Px = _rows(a, u, degree, family)                    # (S, K, cols)
    Py = _rows(b, u, degree, family)
    if family == "nonlinear" and np.isfinite(lasso):
        # budget lasso * N with N the basis size over [x, u]: (d+1)(d+2)/2
        N = (degree + 1) * (degree + 2) // 2
        Kop = lasso_constrained_lstsq(Px, Py, lasso * N, iters=lasso_iters)
    else:
        Kop = gram_lstsq(Px.mT @ Px, Px.mT @ Py,
                         ridge=ridge_for_dtype(Px.dtype))

    # validation rollout from the first validation sample
    UT = Kop.mT
    y0, uv = Yval[:, 0], Uval
    ys = [y0]
    if family in ("linear", "bilinear"):
        N = degree + 1
        A, Bm = UT[:, :N, :N], UT[:, :N, N:]
        z = _poly1d(y0, degree)                         # (S, N)
        for k in range(Yval.shape[1] - 1):
            Az = (A @ z[..., None])[..., 0]
            if family == "linear":
                z = Az + (Bm @ uv[:, k, None, None])[..., 0]
            else:
                z = Az + (Bm @ z[..., None])[..., 0] * uv[:, k, None]
            ys.append(z[:, 0])
    else:
        W = Kop[:, :, 0]            # predicts the next zeta (= x)
        x = y0
        for k in range(Yval.shape[1] - 1):
            feats = _rows(x, uv[:, k], degree, family)
            x = (feats[:, None, :] @ W[..., None])[:, 0, 0]
            ys.append(x)
    ysim = torch.stack(ys, dim=1)
    mean_err = (ysim - Yval).abs().mean(1)
    zero_resp = Yval.abs().mean(1)
    return mean_err / zero_resp


def evaluate_rand_models(datasets: List[DataSet],
                         max_degree_linear: int = 13,
                         max_degree_bilinear: int = 6,
                         max_degree_nonlinear: int = 4,
                         nonlinear_lasso: float = 4.0,
                         lasso_iters: int = 500,
                         mesh=None, dtype=torch.float64,
                         device="cuda") -> dict:
    """The model-class comparison (``evaluate_rand_models.m``) on
    ``device`` in ``dtype``.

    Returns {"linear"|"bilinear"|"nonlinear": {"err": (deg, S) normed
    mean errors, "dims": (deg,) basis-function counts, "median": per
    degree median over the kept systems, "kept": their number}}, a system
    kept unless one of its errors is NaN or above 10
    (``evaluate_rand_models.m:148-156``); host numpy."""
    if mesh is not None:
        raise NotImplementedError(
            "mesh= (the system axis sharded over devices) is not ported "
            "(ROADMAP.md queue 1, item 9)")
    dev = resolve_device(device)
    Ytr, Utr, Yval, Uval = _stack_ensemble(datasets)
    y_fac, y_off, u_fac, u_off = _scale_params(Ytr, Utr)
    args = [torch.as_tensor(v, dtype=dtype, device=dev) for v in (
        (Ytr - y_off[:, None, None]) / y_fac[:, None, None],
        (Utr - u_off[:, None, None]) / u_fac[:, None, None],
        (Yval - y_off[:, None]) / y_fac[:, None],
        (Uval - u_off[:, None]) / u_fac[:, None])]
    plans = [
        ("linear", range(1, max_degree_linear + 1), np.inf,
         lambda d: d + 1),                     # [x..x^d, 1]
        ("bilinear", range(1, max_degree_bilinear + 1), np.inf,
         lambda d: 2 * (d + 1)),               # full_input rows
        ("nonlinear", range(1, max_degree_nonlinear + 1), nonlinear_lasso,
         lambda d: (d + 1) * (d + 2) // 2),    # C(2+d, d) over [x, u]
    ]
    out = {}
    for family, degs, lasso, dim_fn in plans:
        err = np.stack([_fit_and_val(*args, degree=int(d), family=family,
                                     lasso=float(lasso),
                                     lasso_iters=lasso_iters).cpu().numpy()
                        for d in degs])        # (deg, S)
        dims = np.asarray([dim_fn(d) for d in degs])
        keep = np.all(np.isfinite(err), axis=0) & np.all(err < 10, axis=0)
        out[family] = {"err": err, "dims": dims,
                       "median": np.median(err[:, keep], axis=1)
                       if keep.any() else np.full(err.shape[0], np.nan),
                       "kept": int(keep.sum())}
    return out
