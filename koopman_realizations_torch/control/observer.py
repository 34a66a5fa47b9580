"""Load estimation from past measurements (port of ``control/observer.py``
of the JAX package, reference ``Kmpc.estimate_load_*``).

The loaded realization's lifted state is [g; w1 g; ...; w_nw g], so over a
past horizon the dynamics are linear in [1; w]:

    zeta_{i+1} ~= A_z Omega(zeta_i) [1; w] + B_z u_i      (linear model)
    zeta_{i+1} ~= (A_z + sum_j u_ij B_zj) Omega(zeta_i) [1; w]   (bilinear)

with Omega(zeta) = kron(I_{nw+1}, g(zeta)) and A_z / B_z the first nzeta
rows (``estimate_load_linear:1298-1357``, ``estimate_load_bilinear:
1360-1445``).  The equality w0 = 1 is eliminated, the box [-1, 1] and the
optional slope rows |w_j - w_prev_j| <= slope stay, and the linear variant
pins the LAST load component to zero (``Kmpc.m:1349``).

Each lane's estimate is a tiny QP with a per-lane Hessian P (nfree x
nfree) and constraint rows shared by every lane, solved lanes-minor by
``ops/qp.py:solve_qp``: on the card the per-lane-P build of the
``ipm_shared`` kernel (n=2 bilinear, n=1 linear), on the CPU its plain
version.  In the JAX package this QP takes the pure path
(``solve_qp(..., shared_A=False)``, ``ops/qp.py:96-152``), which reaches
no Pallas kernel.  With delays (nd > 0) each regression row is the
delay-embedded zeta of its measurement time (``embed_zetas``).
"""

from __future__ import annotations

import numpy as np
import torch

from koopman_realizations_torch import resolve_device
from koopman_realizations_torch.models.koopman import BilinearModel
from koopman_realizations_torch.ops.observables import zeta_from_window
from koopman_realizations_torch.ops.qp import (
    Constraints,
    band_offset_of,
    constraint_tables,
    solve_qp,
)

# interior-point iterations of each estimate (JAX observer.py:116)
OBS_QP_ITERS = 15


class LoadObserver:
    """observer(k, ywin, uwin, what_prev) -> what, the scaled load
    estimate (nw, B) of lanes-minor trailing windows ywin (W, n, B) and
    uwin (W, m, B) (rows oldest..newest, scaled; the last
    ``load_obs_horizon + 1`` rows feed the regression).  Between update
    steps (k % load_obs_period != 0, and before a full horizon of data,
    k <= load_obs_horizon + nd) the previous estimate is returned unchanged
    (``Ksim.m:185-193``); k is the closed loop's 1-based step counter,
    shared by every lane.  With delays the windows hold nd more rows,
    from which each regression row's zeta is embedded."""

    def __init__(self, model, cfg, device="cuda", dtype=torch.float32):
        meta = model.meta
        if meta.nw == 0:
            raise ValueError("model has no loads (nw == 0)")
        self.device = dev = resolve_device(device)
        self.dtype = dtype
        self.model = model
        self.basis = model.basis
        self.nw, self.N, self.nzeta = meta.nw, meta.N, meta.nzeta
        self.nd = meta.nd
        self.horizon = int(cfg.load_obs_horizon)
        self.period = max(int(cfg.load_obs_period), 1)
        self.slope = cfg.load_obs_slope
        self.bilinear = isinstance(model, BilinearModel)
        self.pin_last = not self.bilinear    # the linear variant's pin
        self.nfree = self.nw - 1 if self.pin_last else self.nw
        nz, nw, N, m = self.nzeta, self.nw, self.N, meta.m
        t = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                                      device=dev)
        self.A3 = t(np.asarray(model.A)[:nz].reshape(nz, nw + 1, N))
        if self.bilinear:
            self.B4 = t(np.asarray(model.B)[:nz].reshape(nz, m, nw + 1, N))
        else:
            self.Bz = t(np.asarray(model.B)[:nz])
        eye = np.eye(self.nfree)
        box = np.concatenate([eye, -eye])
        self.cons_box = self._constraints(box)
        self.cons_slope = None if self.slope is None else \
            self._constraints(np.concatenate([box, eye, -eye]))

    def _constraints(self, F) -> Constraints:
        band = band_offset_of(F)
        row, A_eq, Wd, Wo = constraint_tables(F, band)
        t = lambda a: torch.as_tensor(np.ascontiguousarray(a),
                                      dtype=self.dtype, device=self.device)
        return Constraints(A=t(A_eq), row=t(row), Wd=t(Wd), Wo=t(Wo),
                           n=F.shape[1], mc=F.shape[0], band=band)

    def embed_zetas(self, ywin, uwin) -> torch.Tensor:
        """The zetas of the last load_obs_horizon + 1 measurement times
        (hor+1, nzeta, B), oldest first: the outputs themselves without
        delays, else each time's delay-embedded zeta from the windows
        (JAX ``embed_zetas``, observer.py:70-86: the output, its delays
        newest first, then the input delays; ``zeta_from_window``)."""
        hor, nd = self.horizon, self.nd
        if nd == 0:
            return ywin[-(hor + 1):]
        W = ywin.shape[0]
        return torch.stack([
            zeta_from_window(ywin[i - nd:i + 1], uwin[i - nd:i + 1], nd)
            for i in range(W - 1 - hor, W)])

    def qp(self, ywin, uwin, what_prev=None):
        """The estimate's QP over the lanes, as ``solve_qp``'s positional
        operands: (P (nfree, nfree, B), q (nfree, B), the lane-shared
        ``Constraints``, b (mc, B), iters) -- the box, and the slope rows
        about what_prev when ``load_obs_slope`` is set and it is given."""
        hor, nz, nw = self.horizon, self.nzeta, self.nw
        if ywin.shape[0] < hor + 1 + self.nd:
            raise ValueError(f"the windows need {hor + 1 + self.nd} rows")
        zetas = self.embed_zetas(ywin, uwin).to(self.dtype)  # (hor+1, nz, B)
        us = uwin[-(hor + 1):].to(self.dtype)            # (hor+1, m, B)
        B = zetas.shape[-1]
        g = self.basis.lift(zetas[:-1].permute(1, 0, 2).reshape(nz, -1)) \
            .reshape(self.N, hor, B)                      # (N, hor, B)
        if self.bilinear:
            # M_i = A3 + sum_j u_ij B4[:, j]: (hor, nz, nw+1, N, B)
            M = self.A3[None, ..., None] + torch.einsum(
                "hmb,zmwN->hzwNb", us[:-1], self.B4)
            C = torch.einsum("hzwNb,Nhb->hzwb", M, g)
            d = zetas[1:]
        else:
            C = torch.einsum("zwN,Nhb->hzwb", self.A3, g)
            d = zetas[1:] - torch.einsum("zm,hmb->hzb", self.Bz, us[:-1])
        C = C.reshape(hor * nz, nw + 1, B)
        d = d.reshape(hor * nz, B)
        # eliminate w0 = 1; the linear variant pins the last component
        Cw = C[:, 1:1 + self.nfree]
        resid = d - C[:, 0]
        eye = torch.eye(self.nfree, dtype=self.dtype, device=C.device)
        P = 2.0 * torch.einsum("rib,rjb->ijb", Cw, Cw) + 1e-9 * eye[..., None]
        q = -2.0 * torch.einsum("rib,rb->ib", Cw, resid)
        ones = q.new_ones((2 * self.nfree, B))
        if self.slope is not None and what_prev is not None:
            # |w_j - w_prev_j| <= slope (Kmpc.m:1341-1344)
            wp = what_prev[:self.nfree].to(self.dtype)
            cons = self.cons_slope
            b = torch.cat([ones, self.slope + wp, self.slope - wp])
        else:
            cons, b = self.cons_box, ones
        return (P.contiguous(), q.contiguous(), cons, b.contiguous(),
                OBS_QP_ITERS)

    def estimate(self, ywin, uwin, what_prev=None) -> torch.Tensor:
        """The load estimate (nw, B) of every lane: the QP's solution where
        it is ok, else zero; the linear variant's last component 0."""
        sol = solve_qp(*self.qp(ywin, uwin, what_prev))
        w_free = torch.where(sol.ok[None], sol.x, torch.zeros_like(sol.x))
        if self.pin_last:
            return torch.cat([w_free, w_free.new_zeros((1, w_free.shape[1]))])
        return w_free

    def updates(self, k: int) -> bool:
        """Whether closed-loop step k (1-based) updates the estimate
        (JAX observer.py:121-127: a whole horizon of delay-embedded rows
        behind it)."""
        return k % self.period == 0 and k > self.horizon + self.nd

    def __call__(self, k: int, ywin, uwin, what_prev) -> torch.Tensor:
        if not self.updates(k):
            return what_prev
        return self.estimate(ywin, uwin, what_prev)


def make_load_observer(model, cfg, device="cuda",
                       dtype=torch.float32) -> LoadObserver:
    """The load observer of a loaded model under ``cfg`` (``MpcConfig``:
    ``load_obs_horizon``, ``load_obs_period``, ``load_obs_slope``) on
    ``device`` in ``dtype``."""
    return LoadObserver(model, cfg, device=device, dtype=dtype)


def validate_observer(model, cfg, valtrial, sparse_period: int = 0,
                      device="cuda", dtype=torch.float64) -> dict:
    """The observer over an open-loop validation trial (scaled, an entry
    of ``Ksysid.valdata``), ``Ksysid.val_observer_load:2033-2076`` (with
    ``sparse_period`` > 0 the sparse variant ``:2079-2139``: an update
    every ``sparse_period`` steps, reporting the running mean of the
    estimates), one estimate a step as in the JAX package.  Returns
    {what [T, nw], wreal [T, nw], werr [T, nw]} in scaled space, numpy."""
    obs = make_load_observer(model, cfg, device=device, dtype=dtype)
    back = obs.horizon + obs.nd          # window rows behind the current time
    y, u = np.asarray(valtrial.y), np.asarray(valtrial.u)
    wreal = np.asarray(valtrial.w)
    T, nw = y.shape[0], wreal.shape[1]
    lane = lambda a: torch.as_tensor(a[..., None], dtype=dtype,
                                     device=obs.device)
    what = np.zeros((T, nw))
    history = []
    for i in range(T - 1):
        if i < back or (sparse_period and i % sparse_period != 0):
            what[i + 1] = what[i]
            continue
        prev = lane(what[i]) if cfg.load_obs_slope is not None else None
        w_i = obs.estimate(lane(y[i - back:i + 1]), lane(u[i - back:i + 1]),
                           prev).cpu().numpy()[:, 0]
        if sparse_period:
            history.append(w_i)              # running mean (Ksysid.m:2127)
            what[i + 1] = np.mean(history, axis=0)
        else:
            what[i + 1] = w_i
    return {"what": what, "wreal": wreal, "werr": np.abs(wreal - what)}
