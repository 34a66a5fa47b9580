"""Error metrics of the port: the validation error struct (``get_error``,
``utils/metrics.py:8-29`` of the JAX package), what two trainings are
compared by (one-step predictions, the PC subspace angle), and the
closed-loop tracking error of the runners."""

from __future__ import annotations

import numpy as np
import torch

from koopman_realizations_torch import resolve_device
from koopman_realizations_torch.models.koopman import model_step
from koopman_realizations_torch.ops.observables import delay_embed


def get_error(ysim: torch.Tensor, yreal, scaler=None) -> dict:
    """Error struct between simulated and real outputs in scaled space
    (``Ksysid.get_error:1882-1898``): abs, mean, rmse, nrmse, euclid,
    euclid_mean, and unscaled.euclid(_mean) with a scaler.  Tensors on
    ysim's device, in the wider of the two dtypes."""
    yreal = torch.as_tensor(np.asarray(yreal), device=ysim.device)
    dt = torch.promote_types(ysim.dtype, yreal.dtype)
    ysim, yreal = ysim.to(dt), yreal.to(dt)
    T = yreal.shape[0]
    d = ysim - yreal
    err = {"abs": d.abs()}
    err["mean"] = err["abs"].mean(dim=0)
    err["rmse"] = torch.sqrt((d ** 2).sum(dim=0) / T)
    err["nrmse"] = err["rmse"] / (yreal.max(dim=0).values
                                  - yreal.min(dim=0).values).abs()
    err["euclid"] = torch.sqrt((d ** 2).sum(dim=1))
    err["euclid_mean"] = err["euclid"].sum() / T
    if scaler is not None:
        du = scaler.y_up(ysim) - scaler.y_up(yreal)
        eu = torch.sqrt((du ** 2).sum(dim=1))
        err["unscaled"] = {"euclid": eu, "euclid_mean": eu.sum() / T}
    return err


def one_step_predictions(model, trials, device="cuda") -> np.ndarray:
    """Scaled one-step output predictions of a model over every step of
    ``trials`` (scaled trials): C (A z + B u) (linear), C (A z + Beta(z) u)
    (bilinear), (W^T g([zeta; u]))[:n] (nonlinear), z the lift of the
    step's zeta -- the delay-embedded rows of ``delay_embed`` for a model
    with delays; for a loaded model the loaded lift under the trial's
    load w; for a continuous model one sample Ts of its validation
    stepper (``models/koopman.py:model_step``, the rollouts' first step).
    Invariant to the signs of the PCA components, so two trainings compare
    by it.  f64 on ``device`` (the card unless the caller asks for the
    CPU); returns (steps, n) host numpy."""
    dev = resolve_device(device)
    meta = model.meta

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.float64,
                               device=dev)
    basis = model.basis
    probe = t(0.0)
    step = model_step(model, probe)
    out = []
    for tr in trials:
        zeta, uz = delay_embed(np.asarray(tr.y), np.asarray(tr.u), meta.nd)
        zeta, u = t(zeta)[:-1].T, t(uz)[:-1].T              # (nz|m, T-1)
        w = t(tr.w)[meta.nd:][:-1].T if meta.nw else None
        if meta.model_type == "nonlinear":
            out.append(step(zeta, u, w)[:meta.n])
            continue
        z = basis.lift(zeta) if w is None else basis.lift_loaded(zeta, w)
        out.append(t(model.C) @ step(z, u, w))
    return torch.cat(out, dim=1).T.cpu().numpy()


def subspace_angle(P, Q) -> float:
    """Largest principal angle (rad) between the column spans of P and Q,
    each with orthonormal columns (two trainings' PCA components, sign-
    and rotation-blind): arcsin of the 2-norm of P's part outside span Q.
    Host numpy f64."""
    P, Q = np.asarray(P, np.float64), np.asarray(Q, np.float64)
    r = np.linalg.norm(P - Q @ (Q.T @ P), 2)
    return float(np.arcsin(min(r, 1.0)))


def lane_tracking_error(Yp: torch.Tensor, ref_y) -> torch.Tensor:
    """Per-lane mean Euclidean tracking error, as ``bench.py:159-165``.

    Yp (B, K-1, nproj) tracked outputs of a runner; ref_y (K', nproj) the
    unscaled reference (K' >= K-1).  Output k is compared with reference
    row k (the horizon is anchored at the current row, and the scale round
    trip of the recorded reference is exact to fp eps).  f32 arithmetic,
    as the bench's.
    """
    K1 = Yp.shape[1]
    R = torch.as_tensor(ref_y, device=Yp.device)[:K1].to(torch.float32)
    d = Yp.to(torch.float32) - R[None]
    return torch.sqrt((d ** 2).sum(-1)).mean(1)
