"""Bilinear Koopman MPC of the port: the blocked, lift-fused ``BilinearKmpc``.

Host constants are built in f64 numpy exactly as the JAX package builds
them (``control/kmpc.py``): the input constraint stack
(``input_constraint_rows`` :54, ``_smooth_ts2`` :280), move blocking
(``move_blocking`` :103, checked against ``expected_blocked_keep`` :155),
the ``_KmpcBase`` pieces (:298-355), the blocked input cost ``RdT`` (:551)
and the lift-fused generator fold (:768-902).  Rows that lose every
coefficient under u0 elimination are dropped (they poison the interior
point's row equilibration).

The lane-shared device operands are registered buffers of the module; the
per-step solve runs in ``ops/kernels/bilin_lift.py`` (general runner) or
inside the fused step (``ops/kernels/step_fused.py``).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from koopman_realizations_torch import resolve_device
from koopman_realizations_torch.config import MpcConfig
from koopman_realizations_torch.ops.observables import poly_parent_tables
from koopman_realizations_torch.ops.qp import (
    LiftQP,
    band_offset_of,
    lift_qp_operands,
)


def input_constraint_rows(cfg: MpcConfig, m: int, Np: int, scaler):
    """(F, c) rows acting on the stacked input U in scaled units: bounds
    (stages 1..Np-1; u_0 is pinned and eliminated), slope, smoothness.
    All-zero padding rows of the reference are omitted."""
    F_rows, c_rows = [], []
    if cfg.input_bounds is not None:
        ib = np.asarray(cfg.input_bounds, float)
        if ib.ndim == 1:
            ib = np.tile(ib, (m, 1))
        lo = np.asarray(scaler.u_down(ib[:, 0]))
        hi = np.asarray(scaler.u_down(ib[:, 1]))
        eye = np.eye(m)
        for k in range(1, Np):
            sel = np.zeros((m, m * Np))
            sel[:, k * m:(k + 1) * m] = eye
            F_rows += [-sel, sel]
            c_rows += [-lo, hi]
    if cfg.input_slopeConst is not None:
        lim = cfg.input_slopeConst * float(np.mean(scaler.u_factor))
        for k in range(Np - 1):
            sel = np.zeros((m, m * Np))
            sel[:, (k + 1) * m:(k + 2) * m] = np.eye(m)
            sel[:, k * m:(k + 1) * m] = -np.eye(m)
            F_rows += [sel, -sel]
            c_rows += [np.full(m, lim), np.full(m, lim)]
    if cfg.input_smoothConst is not None:
        lim = cfg.input_smoothConst * float(np.mean(scaler.u_factor))
        for k in range(Np - 2):
            sel = np.zeros((m, m * Np))
            sel[:, k * m:(k + 1) * m] = np.eye(m)
            sel[:, (k + 1) * m:(k + 2) * m] = -2 * np.eye(m)
            sel[:, (k + 2) * m:(k + 3) * m] = np.eye(m)
            F_rows += [sel, -sel]
            c_rows += [np.full(m, lim), np.full(m, lim)]
    if not F_rows:
        return np.zeros((0, m * Np)), np.zeros((0,))
    return np.concatenate(F_rows, axis=0), np.concatenate(c_rows)


def _smooth_ts2(cfg: MpcConfig, Ts: float, c_in: np.ndarray, m: int,
                Np: int):
    """Apply the reference's Ts^2 factor to the smoothness rows."""
    if cfg.input_smoothConst is None:
        return c_in
    c = c_in.copy()
    n_b = 0 if cfg.input_bounds is None else 2 * m * (Np - 1)
    n_s = 0 if cfg.input_slopeConst is None else 2 * m * (Np - 1)
    start = n_b + n_s
    if start + 2 * m * (Np - 2) != c.size:
        raise ValueError("smoothness rows must be last")
    c[start:] *= Ts ** 2
    return c


def move_blocking(blocks, m: int, Np: int, F, cF):
    """Input move-blocking basis and reduced constraint stack.

    U[1:] = Tb @ V with one free move per group.  Returns
    (Tb, Sel, Fr, F0, cr, kept) with Fr @ V <= cr - F0 @ u_prev; rows that
    lose every coefficient (intra-group slope rows) and duplicated group
    bound rows are dropped (first occurrence kept).
    """
    blocks = tuple(int(b) for b in blocks)
    if any(b < 1 for b in blocks):
        raise ValueError(f"input_blocks {blocks} must all be >= 1")
    if sum(blocks) != Np - 1:
        raise ValueError(f"input_blocks {blocks} must sum to Np-1={Np - 1}")
    nf = len(blocks)
    Tb = np.zeros(((Np - 1) * m, nf * m))
    Sel = np.zeros((nf * m, (Np - 1) * m))
    s = 0
    for g, L in enumerate(blocks):
        for k in range(s, s + L):
            Tb[k * m:(k + 1) * m, g * m:(g + 1) * m] = np.eye(m)
        Sel[g * m:(g + 1) * m, s * m:(s + 1) * m] = np.eye(m)
        s += L
    Fr_full = F[:, m:] @ Tb
    F0_full = F[:, :m]
    keep = []
    seen = set()
    for i in range(Fr_full.shape[0]):
        if not Fr_full[i].any() and not F0_full[i].any():
            continue
        key = (np.round(Fr_full[i], 9).tobytes()
               + np.round(F0_full[i], 9).tobytes()
               + np.round(cF[i], 9).tobytes())
        if key in seen:
            continue
        seen.add(key)
        keep.append(i)
    keep = np.asarray(keep, np.int64)
    return Tb, Sel, Fr_full[keep], F0_full[keep], cF[keep], keep


def expected_blocked_keep(cfg: MpcConfig, m: int, Np: int, blocks):
    """Kept-row indices ``move_blocking`` must produce for the
    box-then-slope stack, derived independently (a group's first stage
    keeps its bound rows; a slope row survives at k=0 and at group
    boundaries)."""
    blocks = tuple(int(b) for b in blocks)
    idx = []
    base = 0
    starts = np.concatenate([[0], np.cumsum(blocks)[:-1]])
    if cfg.input_bounds is not None:
        for s in starts:
            idx.extend(range(base + int(s) * 2 * m,
                             base + (int(s) + 1) * 2 * m))
        base += 2 * m * (Np - 1)
    if cfg.input_slopeConst is not None:
        for k in sorted(int(v) for v in starts):
            idx.extend(range(base + k * 2 * m, base + (k + 1) * 2 * m))
        base += 2 * m * (Np - 1)
    return np.asarray(idx, np.int64)


def lift_fused_generators(model, q_diag, proj_idx, Np: int, m: int, Tb):
    """The blocked lift-fused assembly generators (f64).

    For a single-poly + PCA basis the lifted state
    z = [zeta; pcs^T g(zeta); 1] is linear in [zeta; monomials; 1], so the
    PCA projection and the constant fold into the generators of
    W = sqrt(Q) CB[:, m:] Tb (G*), CB0 = sqrt(Q) CB[:, :m] (H*) and
    v0 = sqrt(Q) CA z (P*), each split into z / monomial / bias sections.
    Returns (gens, tables).
    """
    A = np.asarray(model.A, np.float64)
    NL = A.shape[0]
    projmtx = np.asarray(model.C, np.float64)[list(proj_idx), :]
    nproj = projmtx.shape[0]
    powers = [np.eye(NL)]
    for _ in range(Np):
        powers.append(powers[-1] @ A)
    PA = np.stack([projmtx @ p for p in powers])          # (Np+1, nproj, NL)
    PAt = np.zeros((Np + 1, Np, nproj, NL))
    for i in range(Np + 1):
        for j in range(min(i, Np)):
            PAt[i, j] = PA[i - 1 - j]
    p_rows = (Np + 1) * nproj
    Bm64 = np.asarray(model.B, np.float64)
    G64 = np.einsum("ijrb,bmq->irjmq", PAt, Bm64).reshape(p_rows, Np * m, NL)
    sq64 = np.sqrt(np.asarray(q_diag, np.float64))
    Gs = sq64[:, None, None] * G64
    nred = Tb.shape[1]
    Gs_b = np.einsum("rjN,jc->rcN", Gs[:, m:, :], Tb).reshape(p_rows * nred,
                                                              NL)
    H_full = np.concatenate([Gs[:, j, :] for j in range(m)], axis=0)
    P_full = sq64[:, None] * PA.reshape(p_rows, NL)
    basis = model.basis
    nzq = basis.nzeta_aug
    P_T = np.asarray(basis.pcs, np.float64).T               # (npcs, N_full)
    npcs = P_T.shape[0]
    gens = {}
    for name, X in (("G", Gs_b), ("H", H_full), ("P", P_full)):
        Xp = X[:, nzq:nzq + npcs]
        gens[name + "z"] = X[:, :nzq] + Xp @ P_T[:, :nzq]
        gens[name + "m"] = Xp @ P_T[:, nzq:-1]
        gens[name + "b"] = X[:, -1] + Xp @ P_T[:, -1]
    _, tables = poly_parent_tables(nzq, basis.families[0][1])
    return gens, tables


class BilinearKmpc(nn.Module):
    """Blocked lift-fused bilinear MPC (the bench controller).

    One QP per step about Beta(z) held constant over the horizon; the
    decision variable is one free move per input block (u_0 pinned to the
    previous input).  Only this configuration is ported: input blocks set,
    no smoothness or state bounds, no loads, a single poly family with a
    PCA basis, ``bilinear_iters=1``, no dual stage shift.
    """

    def __init__(self, model, scaler, cfg: MpcConfig, device="cuda",
                 dtype=torch.float32):
        super().__init__()
        dev = resolve_device(device)
        basis = model.basis
        if (cfg.input_blocks is None or cfg.input_smoothConst is not None
                or cfg.state_bounds is not None or model.meta.nw != 0
                or cfg.bilinear_iters != 1 or cfg.qp_dual_shift
                or basis.pcs is None or len(basis.families) != 1
                or basis.families[0][0] != "poly"):
            raise NotImplementedError(
                "the port has the blocked lift-fused bilinear controller "
                "only (input_blocks, no smoothness/state bounds/loads, one "
                "poly family with PCA, bilinear_iters=1, no dual shift)")
        self.model = model
        self.meta = meta = model.meta
        self.scaler = scaler
        self.cfg = cfg
        self.Np = Np = cfg.horizon or int(np.floor(1.0 / meta.Ts))
        self.n, self.m = meta.n, meta.m
        m = self.m
        self.NL = meta.NL
        self.proj_idx = tuple(cfg.proj_idx) if cfg.proj_idx is not None \
            else tuple(range(self.n))
        self.nproj = len(self.proj_idx)

        q_diag = np.full((Np + 1, self.nproj), cfg.cost_running)
        q_diag[-1] = cfg.cost_terminal
        self.q_diag = q_diag.reshape(-1)
        r = np.asarray(cfg.cost_input, float).reshape(-1)
        if r.size == 1:
            r = np.full(m, r[0])
        self.r_diag = np.tile(r, Np)

        F, cF = input_constraint_rows(cfg, m, Np, scaler)
        cF = _smooth_ts2(cfg, meta.Ts, cF, m, Np)
        self.F, self.cF = F, cF
        (self.Tb, self.Sel, self.F_red, self.F0_red, self.cF_red,
         kept) = move_blocking(cfg.input_blocks, m, Np, F, cF)
        exp = expected_blocked_keep(cfg, m, Np, cfg.input_blocks)
        if kept.shape != exp.shape or (kept != exp).any():
            raise AssertionError(
                f"move_blocking kept-row layout drift: got {kept}, "
                f"expected {exp}")
        self.band = band_offset_of(self.F_red)
        # Tb^T diag(Rd) Tb is diagonal (disjoint groups)
        self.RdT = self.Tb.T @ self.r_diag[m:]
        self.sqq = np.sqrt(self.q_diag)
        self.lift_gens, self.lift_tables = lift_fused_generators(
            model, self.q_diag, self.proj_idx, Np, m, self.Tb)

        qp = lift_qp_operands(self.lift_gens, self.lift_tables, self.RdT,
                              self.F_red, self.cF_red, self.F0_red,
                              self.band, dtype=dtype, device=dev)
        self._qp_static = {k: getattr(qp, k) for k in
                           ("tables_host", "n", "mc", "p", "m", "nz",
                            "nmono", "band")}
        self._ntables = len(qp.tables)
        for k in ("gens", "rdiag", "A", "cFr", "F0r", "row", "Wd", "Wo"):
            self.register_buffer(k, getattr(qp, k))
        for d, (pi, di) in enumerate(qp.tables):
            self.register_buffer(f"poly_par{d}", pi)
            self.register_buffer(f"poly_dim{d}", di)
        t = lambda a: torch.as_tensor(a, dtype=dtype, device=dev)
        self.register_buffer("Tb_t", t(self.Tb))
        self.register_buffer("Sel_t", t(self.Sel))

    @property
    def n_con(self) -> int:
        return self.cF_red.size

    @property
    def dtype(self) -> torch.dtype:
        return self.gens.dtype

    def lift_qp(self) -> LiftQP:
        """The QP operands as a ``LiftQP`` view of this module's buffers."""
        tables = tuple((getattr(self, f"poly_par{d}"),
                        getattr(self, f"poly_dim{d}"))
                       for d in range(self._ntables))
        return LiftQP(gens=self.gens, tables=tables, rdiag=self.rdiag,
                      A=self.A, cFr=self.cFr, F0r=self.F0r, row=self.row,
                      Wd=self.Wd, Wo=self.Wo, **self._qp_static)
