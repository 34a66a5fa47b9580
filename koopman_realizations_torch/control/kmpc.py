"""Koopman MPC controllers of the port: ``BilinearKmpc`` (blocked and
lift-fused, or off that route: unblocked stacks with or without
smoothness rows, iterated relinearization), the blocked static condensed
``LinearKmpc`` and the blocked SQP ``NonlinearKmpc``; the first two also
on loaded models (the lifted state [g; w1 g; ...] of the load estimate).

Host constants are built in f64 numpy exactly as the JAX package builds
them (``control/kmpc.py``): the input constraint stack
(``input_constraint_rows`` :54, ``_smooth_ts2`` :280), move blocking
(``move_blocking`` :103, checked against ``expected_blocked_keep`` :155),
the ``_KmpcBase`` pieces (:295-423), the linear controller's condensed
matrices (:426-485), the blocked input cost ``RdT`` (:551), the bilinear
assembly generators (:775-861) and the lift-fused generator fold
(:862-902).  Rows that lose every coefficient under u0 elimination are
dropped (they poison the interior point's row equilibration).

The lane-shared device operands are registered buffers of the modules.
The bilinear per-step solve runs in ``ops/kernels/bilin_lift.py``
(general runner) or inside the fused step (``ops/kernels/step_fused.py``);
off the lift-fused route in ``ops/kernels/bilin.py`` (the blocked first
pass of iterated relinearization) and ``ops/kernels/ipm_factored.py``
(every other pass);
the linear one in ``ops/kernels/ipm_shared.py`` (general runner) or inside
its fused step (``ops/kernels/linear_step_fused.py``); the nonlinear
controller's whole SQP in ``ops/kernels/nmpc_multipass.py``, or its passes
one by one in ``ops/kernels/nmpc_stage.py`` / ``nmpc_pass.py``, or, with
the 'linear' between-pass update, the explicit condensation on the host and
each pass's QP in ``ops/kernels/ipm_factored.py`` (its q0 build).  The
nonlinear controller's host constants are the composed maps of F
(``_composed_maps``, kmpc.py:944) and the analytic Jacobian's generator
(``_poly_jacobian_static``, :990), f64 as there.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from koopman_realizations_torch import resolve_device
from koopman_realizations_torch.config import MpcConfig
from koopman_realizations_torch.ops.kernels.bilin import solve_qp_bilinear
from koopman_realizations_torch.ops.kernels.bilin_lift import (
    solve_qp_bilinear_lifted,
)
from koopman_realizations_torch.ops.kernels.ipm_factored import (
    solve_qp_factored,
)
from koopman_realizations_torch.ops.kernels.ipm_shared import (
    shared_operands,
    solve_shared_operands,
)
from koopman_realizations_torch.ops.kernels.nmpc_multipass import (
    solve_qp_nmpc_multipass,
)
from koopman_realizations_torch.ops.kernels.nmpc_pass import (
    solve_qp_nmpc_pass,
)
from koopman_realizations_torch.ops.kernels.nmpc_stage import (
    solve_qp_nmpc_stages,
)
from koopman_realizations_torch.ops.nmpc import (
    NmpcQP,
    condense,
    eval_F,
    jacobian_generator,
    linear_rollout,
    defects,
    merit,
    nmpc_qp_operands,
    rollout,
    stage_lin,
    state_bound_qp,
)
from koopman_realizations_torch.ops.observables import (
    econ_with,
    kron_ones,
    lift_full_with,
    poly_parent_tables,
)
from koopman_realizations_torch.ops.qp import (
    BilinQP,
    Constraints,
    LiftQP,
    QPSolution,
    band_offset_of,
    constraint_tables,
    generator_live,
    lift_qp_operands,
    row_nonzeros,
    solve_qp_lane_A,
)


INF = float("inf")


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


def dual_shift_perm_blocked(cfg: MpcConfig, m: int, nf: int):
    """Stage advance of the multipliers of the move-blocked reduced rows
    (``dual_shift_perm_blocked``, kmpc.py:185-211): bounds nf groups x 2m
    rows, slope nf blocks x 2m, each block seeded from the next group's
    (the last from itself)."""
    idx, base = [], 0
    for on in (cfg.input_bounds is not None,
               cfg.input_slopeConst is not None):
        if not on:
            continue
        for k in range(nf):
            src = min(k + 1, nf - 1)
            idx.extend(range(base + src * 2 * m, base + (src + 1) * 2 * m))
        base += nf * 2 * m
    return np.asarray(idx, np.int64)


def dual_shift_perm(cfg: MpcConfig, m: int, Np: int):
    """Stage advance of the multipliers of the unblocked input rows
    (``dual_shift_perm``, kmpc.py:214-237): a stage-k row of each block
    (bounds over stages 1..Np-1, slope over differences 0..Np-2,
    smoothness over 0..Np-3, 2m rows a stage) is seeded from the old
    stage-(k+1) row, the last stage from itself."""
    idx, base = [], 0
    for on, stages in ((cfg.input_bounds is not None, Np - 1),
                       (cfg.input_slopeConst is not None, Np - 1),
                       (cfg.input_smoothConst is not None, Np - 2)):
        if not on:
            continue
        for k in range(stages):
            src = min(k + 1, stages - 1)
            idx.extend(range(base + src * 2 * m, base + (src + 1) * 2 * m))
        base += stages * 2 * m
    return np.asarray(idx, np.int64)


def state_bound_values(cfg: MpcConfig, n: int, scaler):
    """(lo, hi) (n,) of ``cfg.state_bounds`` in scaled units: one (lo,
    hi) pair for every output or a pair each (kmpc.py:252-258,
    786-792)."""
    sb = np.asarray(cfg.state_bounds, float)
    if sb.ndim == 1:
        sb = np.tile(sb, (n, 1))
    return (np.asarray(scaler.y_down(sb[:, 0]), float),
            np.asarray(scaler.y_down(sb[:, 1]), float))


def state_constraint_rows(cfg: MpcConfig, n: int, NL: int, Np: int, scaler):
    """(E, c) rows bounding the first n lifted coordinates of the stacked
    prediction [z_0; ..; z_Np] (``state_constraint_rows``, kmpc.py:
    240-265): stages 2..Np, each [-sel; sel] with [-lo; hi] (the k=0 and
    k=1 blocks have no coefficient in the reduced decision)."""
    if cfg.state_bounds is None:
        return np.zeros((0, NL * (Np + 1))), np.zeros((0,))
    lo, hi = state_bound_values(cfg, n, scaler)
    E_rows, c_rows = [], []
    for k in range(2, Np + 1):
        sel = np.zeros((n, NL * (Np + 1)))
        sel[:, k * NL:k * NL + n] = np.eye(n)
        E_rows += [-sel, sel]
        c_rows += [-lo, hi]
    return np.concatenate(E_rows, axis=0), np.concatenate(c_rows)


def toeplitz_stack(pp: np.ndarray, Np: int) -> np.ndarray:
    """(Np+1, Np, ...) with [i, j] = pp[i-1-j] for i > j, else zero (the
    pre-gathered block-Toeplitz powers, kmpc.py:797-803)."""
    out = np.zeros((Np + 1, Np) + pp.shape[1:], pp.dtype)
    for i in range(Np + 1):
        for j in range(min(i, Np)):
            out[i, j] = pp[i - 1 - j]
    return out


def bilinear_generators(model, q_diag, proj_idx, Np: int, m: int, Tb=None):
    """The bilinear controller's assembly constants (f64,
    ``BilinearKmpc.__init__``, kmpc.py:770-861): the projected powers
    PA[k] = Cproj A^k (Np+1, nproj, NL) and their Toeplitz gather PAt
    (Np+1, Np, nproj, NL), PAt[i, j] = PA[i-1-j]; PG = PAt . Bm flattened
    over (i, r, j, m) (the shared-Beta CB = unflatten(PG z)); and the
    sqrt(Q)-scaled generators of W = sqrt(Q) CB[:, m:] (Tb) (PGWb: rows
    (r, c); with Tb None the unblocked PGW), CB0 = sqrt(Q) CB[:, :m] (PG0:
    m blocks of p rows) and v0 = sqrt(Q) CA z (PAsq)."""
    A = np.asarray(model.A, np.float64)
    NL = A.shape[0]
    projmtx = np.asarray(model.C, np.float64)[list(proj_idx), :]
    nproj = projmtx.shape[0]
    powers = [np.eye(NL)]
    for _ in range(Np):
        powers.append(powers[-1] @ A)
    PA = np.stack([projmtx @ p for p in powers])          # (Np+1, nproj, NL)
    PAt = toeplitz_stack(PA, Np)
    p_rows = (Np + 1) * nproj
    Bm64 = np.asarray(model.B, np.float64)
    G64 = np.einsum("ijrb,bmq->irjmq", PAt, Bm64).reshape(p_rows, Np * m, NL)
    sq64 = np.sqrt(np.asarray(q_diag, np.float64))
    Gs = sq64[:, None, None] * G64
    W = Gs[:, m:, :] if Tb is None else \
        np.einsum("rjN,jc->rcN", Gs[:, m:, :], Tb)
    return {"PA": PA, "PAt": PAt, "PG": G64.reshape(-1, NL),
            "PGWb": W.reshape(-1, NL),
            "PG0": np.concatenate([Gs[:, j, :] for j in range(m)], axis=0),
            "PAsq": sq64[:, None] * PA.reshape(p_rows, NL)}


def lift_fused_generators(model, q_diag, proj_idx, Np: int, m: int, Tb):
    """The blocked lift-fused assembly generators (f64).

    For a single-poly + PCA basis the lifted state
    z = [zeta; pcs^T g(zeta); 1] is linear in [zeta; monomials; 1], so the
    PCA projection and the constant fold into the generators of
    W = sqrt(Q) CB[:, m:] Tb (G*), CB0 = sqrt(Q) CB[:, :m] (H*) and
    v0 = sqrt(Q) CA z (P*), each split into z / monomial / bias sections.
    Returns (gens, tables).
    """
    g = bilinear_generators(model, q_diag, proj_idx, Np, m, Tb)
    basis = model.basis
    nzq = basis.nzeta_aug
    P_T = np.asarray(basis.pcs, np.float64).T               # (npcs, N_full)
    npcs = P_T.shape[0]
    gens = {}
    for name, key in (("G", "PGWb"), ("H", "PG0"), ("P", "PAsq")):
        X = g[key]
        Xp = X[:, nzq:nzq + npcs]
        gens[name + "z"] = X[:, :nzq] + Xp @ P_T[:, :nzq]
        gens[name + "m"] = Xp @ P_T[:, nzq:-1]
        gens[name + "b"] = X[:, -1] + Xp @ P_T[:, -1]
    _, tables = poly_parent_tables(nzq, basis.families[0][1])
    return gens, tables


class _KmpcBase(nn.Module):
    """What the controllers share (``_KmpcBase``, kmpc.py:295-423):
    dimensions, projection, the Q/R diagonals over the horizon, the input
    constraint stack -- under move blocking, or unblocked (reduced rows
    F[:, m:], F0 = F[:, :m]) -- and its band (None with smoothness rows:
    a dense A^T D A), the basis's lift, and the lane-shared device operands
    of the constraints (row-equilibrated A with its A^T D A tables, cFr,
    F0r), of the blocking (Tb, Sel; None unblocked) and of the lift (each
    family's operands, ``ops/observables.py:family_operands``, and the
    PCA matrix where the basis has one).

    Ported: every dictionary (any list of families, with or without PCA,
    with delays), input blocks without smoothness, or no blocks with or
    without smoothness (the blocked JAX controller refuses smoothness
    too); loaded models (nw > 0), with or without delays, whose lifted
    state is [g; w1 g; ...] of the scaled load estimate (``lift``; g the
    lift of the delay-embedded zeta); the dual stage
    shift of carried multipliers (``shift_lam``); state bounds on
    unblocked stacks (the linear and bilinear controllers; blocked
    stacks refuse them, as the JAX base does, kmpc.py:334-338).
    """

    def __init__(self, model, scaler, cfg: MpcConfig, device, dtype):
        super().__init__()
        dev = resolve_device(device)
        basis = model.basis
        if cfg.input_blocks is not None and (
                cfg.input_smoothConst is not None
                or cfg.state_bounds is not None):
            raise NotImplementedError(
                "input_blocks with input_smoothConst/state_bounds is not "
                "supported")
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
        self.projmtx = np.asarray(model.C)[list(self.proj_idx), :]

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
        self.blocked = cfg.input_blocks is not None
        if self.blocked:
            (self.Tb, self.Sel, self.F_red, self.F0_red, self.cF_red,
             kept) = move_blocking(cfg.input_blocks, m, Np, F, cF)
            exp = expected_blocked_keep(cfg, m, Np, cfg.input_blocks)
            if kept.shape != exp.shape or (kept != exp).any():
                raise AssertionError(
                    f"move_blocking kept-row layout drift: got {kept}, "
                    f"expected {exp}")
        else:
            self.Tb = self.Sel = None
            self.F_red, self.F0_red, self.cF_red = F[:, m:], F[:, :m], cF
        self.band = band_offset_of(self.F_red)
        self.dense_cols = () if self.band is not None else \
            row_nonzeros(self.F_red)[0]
        # the receding-horizon stage shift of carried multipliers
        # (``qp_dual_shift``, kmpc.py:356-376): a row permutation of the
        # input rows, extended with the identity over state-bound rows
        # (``extend_dual_shift``) once the controller knows its rows
        self.dual_shift = None
        if cfg.qp_dual_shift and F.shape[0]:
            self.dual_shift = dual_shift_perm_blocked(
                cfg, m, len(cfg.input_blocks)) if self.blocked \
                else dual_shift_perm(cfg, m, Np)
            if self.dual_shift.size != self.F_red.shape[0]:
                raise AssertionError(
                    f"dual shift layout drift: the permutation covers "
                    f"{self.dual_shift.size} rows, the stack has "
                    f"{self.F_red.shape[0]}")
        # the poly recurrence's tables: the lift-fused kernels and the
        # analytic NMPC take them (a single poly family)
        self.tables_host = ()
        if basis.single_poly:
            _, tables = poly_parent_tables(basis.nzeta_aug,
                                           basis.families[0][1])
            self.tables_host = tuple(
                (tuple(int(v) for v in pi), tuple(int(v) for v in di))
                for pi, di in tables)

        t = lambda a: None if a is None else torch.as_tensor(
            np.ascontiguousarray(a), dtype=dtype, device=dev)
        row, A_eq, Wd, Wo = constraint_tables(self.F_red, self.band)
        for k, v in (("A", A_eq), ("row", row), ("Wd", Wd), ("Wo", Wo),
                     ("cFr", self.cF_red / row),
                     ("F0r", self.F0_red / row[:, None]),
                     ("Tb_t", self.Tb), ("Sel_t", self.Sel),
                     ("pcsT_t", None if basis.pcs is None else basis.pcs.T)):
            self.register_buffer(k, t(v))
        self._lift_keys = []
        for f, ops in enumerate(basis.operands(dtype, dev)):
            self._lift_keys.append(tuple(ops))
            for k, v in ops.items():
                self.register_buffer(f"lift{f}_{k}", v)

    @property
    def n_con(self) -> int:
        return self.cF_red.size

    def extend_dual_shift(self, n_con: int):
        """The dual shift as a device index tensor over all ``n_con``
        rows, state-bound rows keeping their own multiplier
        (``_extend_dual_shift``, kmpc.py:378-387)."""
        if self.dual_shift is None:
            return
        perm = np.concatenate([self.dual_shift,
                               np.arange(self.dual_shift.size, n_con)])
        self.register_buffer("shift_idx", torch.as_tensor(
            perm, dtype=torch.long, device=self.device))

    def shift_lam(self, lam0):
        """A carried dual start (mc, B) advanced one stage
        (``_shift_lam``, kmpc.py:389-393); as it is without the shift."""
        if lam0 is None or self.dual_shift is None:
            return lam0
        return lam0[self.shift_idx]

    @property
    def dtype(self) -> torch.dtype:
        return self.A.dtype

    @property
    def device(self) -> torch.device:
        return self.A.device

    def constraints(self) -> Constraints:
        """The reduced constraint rows as a ``Constraints`` view of this
        module's buffers."""
        return Constraints(A=self.A, row=self.row, Wd=self.Wd, Wo=self.Wo,
                           n=self.A.shape[1], mc=self.A.shape[0],
                           band=self.band, cols=self.dense_cols)

    def poly_tables(self):
        """The poly lift's (parent, dim) index tables on the device (a
        single poly family)."""
        return tuple((getattr(self, f"lift0_par{d}"),
                      getattr(self, f"lift0_dim{d}"))
                     for d in range(len(self.tables_host)))

    def lift_operands(self) -> list:
        """Each family's operands, as buffers of this module."""
        return [{k: getattr(self, f"lift{f}_{k}") for k in keys}
                for f, keys in enumerate(self._lift_keys)]

    def lift_econ(self, zeta) -> torch.Tensor:
        """The basis's working lift of lanes-minor zeta_aug (nz, B): the
        full basis [zeta; features; 1] on this module's operands, then
        [zeta; pcs^T g; 1] with PCA (``KoopmanBasis.lift``): (N, B)."""
        g = lift_full_with(self.model.basis.families, self.lift_operands(),
                           zeta)
        return econ_with(self.pcsT_t, zeta, g)

    def warm_start(self, U_plan) -> torch.Tensor:
        """Primal start of the reduced decision (``_warm_start``, with
        ``Sel`` when blocked, kmpc.py:412-423, 665-672): the previous plan
        U_plan (Np*m, B) shifted by one stage (one move per group)."""
        m = self.m
        shifted = torch.cat([U_plan[2 * m:], U_plan[-m:]])
        return self.Sel_t @ shifted if self.blocked else shifted

    def lift(self, zeta, what=None) -> torch.Tensor:
        """The lifted state of lanes-minor zeta (nz, B): the basis's
        working lift (``lift_econ``), and for a loaded model its blocks
        [z; w1 z; ...] under the scaled load estimate ``what`` (nw, B)
        (``lift_loaded``; JAX ``ksim.py:97-114``): (NL, B)."""
        if (what is None) != (self.meta.nw == 0):
            raise ValueError("a loaded model's lift takes the load "
                             "estimate, an unloaded one none")
        z = self.lift_econ(zeta)
        return z if what is None else kron_ones(what.to(z.dtype), z)

    def plan(self, u_prev, x) -> torch.Tensor:
        """The plan [u_prev; Tb x] (Np*m, B) of a reduced decision x (Tb
        the identity unblocked)."""
        return torch.cat([u_prev, self.Tb_t @ x if self.blocked else x])


class BilinearKmpc(_KmpcBase):
    """Bilinear MPC: B depends on the current lifted state
    (``BilinearKmpc``, kmpc.py:588-941, ``bilinear_solve_pure``).

    ``bilinear_iters`` QPs a step; the first about Beta(z) held constant
    over the horizon (the reference's choice at ``Ksim.m:210``), each later
    one about the lifted trajectory re-rolled under the previous QP's plan
    (``get_mpcInput_bilinear_iter``, ``Kmpc.m:817-904``).  The decision is
    one free move per input block, or the whole stack [u_1 .. u_{Np-1}]
    unblocked; u_0 is pinned to the previous input.  The route is the JAX
    controller's:

    - **lift-fused** (blocked, ``bilinear_iters=1``, no loads, one poly
      family with PCA, delays or not; the bench controller; JAX
      ``kmpc.py:864-903``) -- one ``bilin_lift`` launch from the raw zeta
      (``wants_zeta``), or the whole step inside the fused step kernel;
    - otherwise (any other dictionary, a basis without PCA, a loaded
      model: its lifted state carries the load estimate, JAX
      ``kmpc.py:862-864``) the runner lifts zeta, and the
      first QP is one ``bilin``
      launch from z (blocked) or the host's shared-Beta assembly
      W, v = f(PG z) and one ``ipm_factored`` launch (unblocked); each
      later QP re-rolls the lifted state on the host, forms the
      block-Toeplitz CB from the stage Betas as batched products and
      runs ``ipm_factored``.  Every QP starts from the shifted previous
      plan; each passes its multipliers to the next, the last the step's.
    """

    def __init__(self, model, scaler, cfg: MpcConfig, device="cuda",
                 dtype=torch.float32):
        if model.meta.model_type != "bilinear" or cfg.bilinear_iters < 1 \
                or cfg.mpc_type not in (None, "linear"):
            raise NotImplementedError(
                "BilinearKmpc takes a bilinear model with bilinear_iters "
                ">= 1 (mpc_type='nonlinear' on it is the bilinear-as-NMPC "
                "controller, NonlinearKmpc; see make_kmpc)")
        super().__init__(model, scaler, cfg, device, dtype)
        m = self.m
        self.has_sb = cfg.state_bounds is not None
        self.extend_dual_shift(self.n_con)
        # Tb^T diag(Rd) Tb is diagonal (disjoint groups)
        self.RdT = self.Tb.T @ self.r_diag[m:] if self.blocked \
            else self.r_diag[m:]
        self.sqq = np.sqrt(self.q_diag)
        self.p = self.sqq.size
        # the route (kmpc.py:688-742, 863-869); a loaded model's lifted
        # state is not the poly lift's, so it takes the z route
        self.lift_fused = self.blocked and cfg.bilinear_iters == 1 \
            and self.meta.nw == 0 and model.basis.pcs is not None \
            and model.basis.single_poly
        self.wants_zeta = self.lift_fused
        t = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                                      device=self.device)
        if self.lift_fused:
            self.lift_gens, self.lift_tables = lift_fused_generators(
                model, self.q_diag, self.proj_idx, self.Np, m, self.Tb)
            qp = lift_qp_operands(self.lift_gens, self.lift_tables, self.RdT,
                                  self.F_red, self.cF_red, self.F0_red,
                                  self.band, dtype=dtype, device=self.device)
            self._qp_static = {k: getattr(qp, k) for k in
                               ("tables_host", "n", "mc", "p", "m", "nz",
                                "nmono", "band", "live")}
            for k in ("gens", "rdiag"):
                self.register_buffer(k, getattr(qp, k))
            return
        self.lift_gens = self.lift_tables = None
        self.gens_host = g = bilinear_generators(
            model, self.q_diag, self.proj_idx, self.Np, m, self.Tb)
        NL, Np = self.NL, self.Np
        for k, v in (("rdiag", self.RdT), ("sqq_t", self.sqq),
                     ("cF_t", self.cF_red), ("F0_t", self.F0_red),
                     ("A_t", model.A), ("Bm_t", np.asarray(model.B)
                                        .reshape(NL * m, NL)),
                     ("PA_t", g["PA"].reshape(self.p, NL)),
                     ("PAt_t", g["PAt"].transpose(1, 0, 2, 3)
                      .reshape(Np, self.p, NL))):
            self.register_buffer(k, t(v))
        if self.blocked:
            # [PGWb; PG0; PAsq] on z, columns padded to a multiple of 4
            stack = np.concatenate([g[k] for k in ("PGWb", "PG0", "PAsq")])
            gens = np.zeros((stack.shape[0], -(-NL // 4) * 4))
            gens[:, :NL] = stack
            self.register_buffer("gens", t(gens))
            self.gens_live = generator_live(
                torch.as_tensor(gens, dtype=dtype), self.p,
                self.Tb.shape[1], m)
        else:
            self.register_buffer("PG_t", t(g["PG"]))
        if self.has_sb:
            # the state-bound rows' operands (kmpc.py:779-822): EA[k] =
            # (A^k)[:n] and its block-Toeplitz gather, the bounds in
            # scaled units, the full input rows and cost diagonals
            A64 = np.asarray(model.A, np.float64)
            powers = [np.eye(NL)]
            for _ in range(Np):
                powers.append(powers[-1] @ A64)
            EA = np.stack([pw[:self.n] for pw in powers])   # (Np+1, n, NL)
            EAt = toeplitz_stack(EA, Np)
            lo, hi = state_bound_values(cfg, self.n, scaler)
            for k, v in (("EA_t", EA.reshape(-1, NL)),
                         ("EAt_t", EAt.transpose(1, 0, 2, 3)
                          .reshape(Np, (Np + 1) * self.n, NL)),
                         ("sb_lo_t", np.tile(lo, Np - 1)),
                         ("sb_hi_t", np.tile(hi, Np - 1)),
                         ("Fr_t", self.F_red), ("Qd_t", self.q_diag),
                         ("Rd_t", self.r_diag)):
                self.register_buffer(k, t(v))

    @property
    def n_con(self) -> int:
        """The reduced QP's rows: the input rows, and with state bounds
        2 n (Np - 1) more (kmpc.py:906-913)."""
        return self.cF_red.size + (2 * self.n * (self.Np - 1)
                                   if getattr(self, "has_sb", False) else 0)

    def lift_qp(self) -> LiftQP:
        """The lift-fused QP operands as a ``LiftQP`` view of this
        module's buffers."""
        if not self.lift_fused:
            raise NotImplementedError(
                "the lift-fused QP needs input_blocks, bilinear_iters=1 "
                "and one poly family with PCA")
        return LiftQP(gens=self.gens, tables=self.poly_tables(),
                      rdiag=self.rdiag, A=self.A, cFr=self.cFr,
                      F0r=self.F0r, row=self.row, Wd=self.Wd, Wo=self.Wo,
                      **self._qp_static)

    def bilin_qp(self) -> BilinQP:
        """The assembly-fused first pass's operands (blocked, off the
        lift-fused route) as a ``BilinQP`` view of this module's
        buffers."""
        return BilinQP(gens=self.gens, rdiag=self.rdiag, A=self.A,
                       cFr=self.cFr, F0r=self.F0r, row=self.row, Wd=self.Wd,
                       Wo=self.Wo, n=self.A.shape[1], mc=self.A.shape[0],
                       p=self.p, m=self.m, nzl=self.NL, band=self.band,
                       live=self.gens_live)

    def solve(self, z, u_prev, sqYr, U_plan, lam0=None):
        """One batched MPC solve (``BilinearKmpc.solve``), lanes-minor:
        z (nz, B) the scaled outputs on the lift-fused route (the kernel
        lifts them), else (NL, B) the lifted states; u_prev (m, B) the
        scaled previous input, sqYr (p,) or (p, B) the sqrt(Q)-scaled
        reference window, U_plan (Np*m, B) the previous plan, lam0 (mc, B)
        the previous multipliers (None: cold), advanced one stage first
        with ``qp_dual_shift``.  Returns the plan U (Np*m, B) and the last
        QP's ``QPSolution``.  With state bounds every QP has its own
        Hessian and rows a lane (``state_bound_qp``) and is solved by
        ``ops/qp.py:solve_qp_lane_A`` (the JAX package's
        ``solve_qp(shared_A=False)``, which never reaches Pallas)."""
        cfg = self.cfg
        x0 = self.warm_start(U_plan)
        lam0 = self.shift_lam(lam0)
        if self.lift_fused:
            sol = solve_qp_bilinear_lifted(self.lift_qp(), z, u_prev, sqYr,
                                           x0=x0, lam0=lam0,
                                           iters=cfg.qp_iters)
            return self.plan(u_prev, sol.x), sol
        lam, betas = lam0, None
        for it in range(cfg.bilinear_iters):
            if self.has_sb:
                if betas is None:
                    beta = (self.Bm_t @ z).reshape(self.NL, self.m, -1)
                    betas = beta.expand(self.Np, *beta.shape)
                sol = solve_qp_lane_A(*self.state_bound_qp(
                    z, u_prev, sqYr, betas), iters=cfg.qp_iters, x0=x0,
                    lam0=lam)
            elif it == 0 and self.blocked:
                sol = solve_qp_bilinear(self.bilin_qp(), z, u_prev, sqYr,
                                        x0=x0, lam0=lam, iters=cfg.qp_iters)
            else:
                W, v = self.factored_data(z, u_prev, sqYr, betas)
                b = self.cF_t[:, None] - self.F0_t @ u_prev
                sol = solve_qp_factored(W, v, self.rdiag, self.constraints(),
                                        b, x0=x0, lam0=lam,
                                        iters=cfg.qp_iters)
            U, lam = self.plan(u_prev, sol.x), sol.lam
            if it + 1 < cfg.bilinear_iters:
                betas = self.roll(z, U)[1]
        return U, sol

    def state_bound_qp(self, z, u_prev, sqYr, betas):
        """The reduced QP with state-bound rows of every lane
        (``bilinear_solve_pure``'s ``has_sb`` branch, kmpc.py:645-664,
        671-687): CB and the bounded coordinates' EW block-Toeplitz in the
        stage Betas ``betas`` (Np, NL, m, B), P = 2 (CB^T Q CB +
        diag(Rd)), f = 2 CB^T Q (CA z - Yr), rows [F; -EW; EW] with
        b = [cF; zn - lo; hi - zn] (zn the free response of the bounded
        coordinates, stages 2..Np), then u_0 pinned to u_prev.  Returns
        (Pz (n, n, B), fz (n, B), Az (mc, n, B), bz (mc, B))."""
        m, n, Np, B = self.m, self.n, self.Np, z.shape[1]
        CB = torch.einsum("jrb,jbmB->rjmB", self.PAt_t, betas) \
            .reshape(self.p, Np * m, B)
        EW = torch.einsum("jrb,jbmB->rjmB", self.EAt_t, betas) \
            .reshape((Np + 1) * n, Np * m, B)[2 * n:]
        sq = self.sqq_t[:, None]
        sq_ref = sqYr if sqYr.ndim == 2 else sqYr[:, None]
        e = sq * (sq * (self.PA_t @ z) - sq_ref)          # Q (CA z - Yr)
        CBb = CB.permute(2, 0, 1).contiguous()              # (B, p, Np m)
        H = ((CBb * self.Qd_t[:, None]).transpose(1, 2) @ CBb).permute(
            1, 2, 0) + torch.diag(self.Rd_t)[..., None]
        P = 2.0 * H
        f = 2.0 * torch.einsum("rib,rb->ib", CB, e)
        zn = (self.EA_t @ z)[2 * n:]
        Fz = torch.cat([self.F0_t, self.Fr_t], dim=1)
        L = torch.cat([Fz[..., None].expand(*Fz.shape, B), -EW, EW])
        b = torch.cat([self.cF_t[:, None].expand(-1, B),
                       zn - self.sb_lo_t[:, None],
                       self.sb_hi_t[:, None] - zn])
        Pz = P[m:, m:]
        fz = f[m:] + torch.einsum("ijb,jb->ib", P[m:, :m], u_prev)
        bz = b - torch.einsum("cjb,jb->cb", L[:, :m], u_prev)
        return (Pz.contiguous(), fz.contiguous(), L[:, m:].contiguous(),
                bz.contiguous())

    def roll(self, z, U):
        """The lifted states z_0 .. z_{Np-1} (Np, NL, B) under the plan U
        (Np*m, B), z_{k+1} = A z_k + Beta(z_k) u_k (kmpc.py:749-754), with
        the stage Betas Beta(z_k) (Np, NL, m, B) they give."""
        m, NL, B = self.m, self.NL, z.shape[1]
        zs, betas = [z], []
        for k in range(self.Np):
            betas.append((self.Bm_t @ zs[-1]).reshape(NL, m, B))
            if k + 1 < self.Np:
                u = U[k * m:(k + 1) * m]
                zs.append(self.A_t @ zs[-1]
                          + torch.einsum("kmb,mb->kb", betas[-1], u))
        return torch.stack(zs), torch.stack(betas)

    def factored_data(self, z, u_prev, sqYr, betas=None):
        """The factored QP's W (p, n, B) and v (p, B) (``_qp_data_inner``,
        kmpc.py:627-647, 726-742): W = sqrt(Q) CB[:, m:] (Tb when
        blocked), v = sqrt(Q) (CA z + CB[:, :m] u_prev) - sqYr, with CB
        from Beta(z) held over the horizon (``betas`` None:
        unflatten(PG z)) or block-Toeplitz from the stage Betas of a
        re-rolled trajectory (``roll``): CB[(i, r), (j, :)] =
        PAt[i, j] Beta_j."""
        m, p, B = self.m, self.p, z.shape[1]
        if betas is None:
            CB = (self.PG_t @ z).reshape(p, self.Np * m, B)
        else:
            CB = torch.einsum("jrb,jbmB->rjmB", self.PAt_t, betas) \
                .reshape(p, self.Np * m, B)
        sq = self.sqq_t[:, None]
        W = sq[..., None] * CB[:, m:]
        if self.blocked:
            W = torch.einsum("rjB,jc->rcB", W, self.Tb_t)
        v = sq * (self.PA_t @ z + torch.einsum("rjB,jB->rB", CB[:, :m],
                                               u_prev))
        sq_ref = sqYr if sqYr.ndim == 2 else sqYr[:, None]
        return W, v - sq_ref


class LinearKmpc(_KmpcBase):
    """Linear-model MPC with static condensed matrices (``LinearKmpc``,
    kmpc.py:426-523): the decision is [u_0 | one move per group] (blocked)
    or the whole stack [u_0 .. u_{Np-1}] (unblocked), u_0 pinned to the
    previous input and eliminated, so the QP has the lane-shared Hessian
    P22 of 2H, lane-shared rows L[:, m:] and per-lane gradients and
    right-hand sides b = c - M z.  Unblocked, the rows may bound the first
    n lifted coordinates of the prediction (``state_constraint_rows``):
    L = [F; E Bbig], M = [0; E Abig] (kmpc.py:461-467), the A^T D A then
    dense.  The duals start cold, or from the previous step's multipliers
    (``qp_dual_warm``, with ``qp_dual_shift`` advanced one stage): the
    ``ipm_shared`` kernel's lane-shared build of each (JAX: the Pallas
    ``_ipm_kernel`` with ``warm_dual``, ops/qp.py:133-146).

    Host constants (f64 numpy, as the JAX package): ``CA``, ``CB`` (with
    Tfull = blockdiag(I_m, Tb) folded in when blocked), ``H``, ``L``
    ([F0_red | F_red] blocked), ``Mc`` and ``c``.
    """

    def __init__(self, model, scaler, cfg: MpcConfig, device="cuda",
                 dtype=torch.float32):
        if model.meta.model_type != "linear" \
                or cfg.mpc_type not in (None, "linear"):
            raise NotImplementedError("LinearKmpc takes a linear model")
        super().__init__(model, scaler, cfg, device, dtype)
        A = np.asarray(model.A)
        B = np.asarray(model.B)
        NL, m, Np = self.NL, self.m, self.Np
        powers = [np.eye(NL)]
        for _ in range(Np):
            powers.append(powers[-1] @ A)
        # stacked prediction: z_i = A^i z0 + sum_j A^(i-1-j) B u_j
        Abig = np.concatenate(powers, axis=0)
        Bbig = np.zeros((NL * (Np + 1), m * Np))
        for i in range(1, Np + 1):
            for j in range(i):
                Bbig[i * NL:(i + 1) * NL, j * m:(j + 1) * m] = \
                    powers[i - 1 - j] @ B
        Cbig = np.kron(np.eye(Np + 1), self.projmtx)
        self.CA = Cbig @ Abig
        self.CB = Cbig @ Bbig
        if self.blocked:
            Tfull = np.zeros((Np * m, m + self.Tb.shape[1]))
            Tfull[:m, :m] = np.eye(m)
            Tfull[m:, m:] = self.Tb
            self.CB = self.CB @ Tfull
            self.L = np.concatenate([self.F0_red, self.F_red], axis=1)
            self.Mc = np.zeros((self.L.shape[0], NL))
            self.c = self.cF_red
            rd = np.concatenate([self.r_diag[:m], self.Tb.T @ self.r_diag[m:]])
        else:
            E, cE = state_constraint_rows(cfg, self.n, NL, Np, scaler)
            self.L = np.concatenate([self.F, E @ Bbig], axis=0)
            self.Mc = np.concatenate([np.zeros((self.F.shape[0], NL)),
                                      E @ Abig], axis=0)
            self.c = np.concatenate([self.cF, cE])
            rd = self.r_diag
        self.H = self.CB.T @ (self.q_diag[:, None] * self.CB) + np.diag(rd)
        if not self.blocked:
            # bitwise symmetric, as the kernel reads one triangle of P22
            self.H = 0.5 * (self.H + self.H.T)
        if not self.blocked and cfg.state_bounds is not None:
            # the QP's rows are L[:, m:]: the input rows and the
            # state-bound rows, whose A^T D A is dense (kmpc.py:354-355)
            Lz = self.L[:, m:]
            self.band = None
            self.dense_cols = row_nonzeros(Lz)[0]
            row, A_eq, Wd, Wo = constraint_tables(Lz, None)
            t = lambda a: torch.as_tensor(np.ascontiguousarray(a),
                                          dtype=dtype, device=self.device)
            for k, v in (("A", A_eq), ("row", row), ("Wd", Wd),
                         ("Wo", Wo)):
                self.register_buffer(k, t(v))
        self.extend_dual_shift(self.n_con)

        t = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                                      device=self.device)
        for k in ("CA", "CB", "H", "L", "Mc", "c"):
            self.register_buffer(k + "_t", t(getattr(self, k)))
        self.register_buffer("Qd_t", t(self.q_diag))

    @property
    def n_con(self) -> int:
        """The reduced QP's rows, the state-bound rows included."""
        return self.c.size if hasattr(self, "c") else self.cF_red.size

    def eliminate_u0(self, P, f, b, u0):
        """Pin the first input block to u0 and reduce the QP
        (``_eliminate_u0``, kmpc.py:397-407): (P22, fz, bz); the reduced
        rows L[:, m:] are ``constraints()``."""
        m = self.m
        return (P[m:, m:], f[m:] + P[m:, :m] @ u0,
                b - self.L_t[:, :m] @ u0)

    def qp_args(self, z, u_prev, Yr, U_plan, lam0=None) -> tuple:
        """The equilibrated ``ipm_shared`` arguments of one solve's reduced
        QP and its objective scale (``shared_operands``), lanes-minor:
        z (NL, B) lifted states, u_prev (m, B) the scaled previous input,
        Yr (p,) or (p, B) the scaled reference window, U_plan (Np*m, B)
        the previous plan, lam0 (mc, B) the previous multipliers in
        original units (None: cold), advanced one stage with
        ``qp_dual_shift``."""
        Yr = Yr if Yr.ndim == 2 else Yr[:, None]
        # f = 2 CB^T Q (CA z - Yr)
        f = 2.0 * self.CB_t.T @ (self.Qd_t[:, None] * (self.CA_t @ z - Yr))
        b = self.c_t[:, None] - self.Mc_t @ z
        Pz, fz, bz = self.eliminate_u0(2.0 * self.H_t, f, b, u_prev)
        return shared_operands(Pz, fz, self.constraints(), bz,
                               x0=self.warm_start(U_plan),
                               iters=self.cfg.qp_iters,
                               lam0=self.shift_lam(lam0))

    def solve(self, z, u_prev, Yr, U_plan, lam0=None):
        """One batched MPC solve (``LinearKmpc.solve``) of ``qp_args``'
        QP.  Returns the plan U (Np*m, B) and the ``QPSolution``."""
        sol = solve_shared_operands(*self.qp_args(z, u_prev, Yr, U_plan,
                                                  lam0))
        return self.plan(u_prev, sol.x), sol


def composed_maps(model):
    """Host-side (A1, A2, a0) of the composed F(x) = A1 x + A2 feats(x) +
    a0 of a nonlinear model (``_composed_maps``, kmpc.py:944-965): the PCA
    projection and the output map W^T folded into one matrix per term of
    the raw features g_full = [x; feats(x); 1], in f64."""
    basis = model.basis
    W_T = np.asarray(model.W, np.float64).T             # (nzeta, N)
    nza = basis.nzeta_aug
    if basis.pcs is None:
        return W_T[:, :nza], W_T[:, nza:-1], W_T[:, -1]
    P_T = np.asarray(basis.pcs, np.float64).T           # (npcs, N_full)
    Wp = W_T[:, nza:-1]
    return (W_T[:, :nza] + Wp @ P_T[:, :nza], Wp @ P_T[:, nza:-1],
            W_T[:, -1] + Wp @ P_T[:, -1])


def poly_jacobian_static(model):
    """Static pieces of the composed F's analytic Jacobian
    (``_poly_jacobian_static``, kmpc.py:990-1029): (A1, G, blocks, tables,
    pos_x) with J(x).flatten() = A1.flatten() + G @ g_low(x),
    g_low = [x; monomial blocks of degree 2..d-1], rows (o, i) =
    o*nza + i, and ``pos_x[j]`` the g_low column of x_j; f64.  Needs a
    single poly family of degree >= 2."""
    basis = model.basis
    (kind, degree), = basis.families
    if kind != "poly" or degree < 2:
        raise NotImplementedError("the analytic Jacobian needs one poly "
                                  "family of degree >= 2")
    nza = basis.nzeta_aug
    A1, A2, _ = composed_maps(model)
    nzo = A1.shape[0]
    blocks, tables = poly_parent_tables(nza, degree)
    pos, off = {}, 0
    for d in range(1, degree):
        for r, e in enumerate(blocks[d - 1]):
            pos[tuple(int(v) for v in e)] = off + r
        off += len(blocks[d - 1])
    G = np.zeros((nzo * nza, off), np.float64)
    fr = 0
    for d in range(2, degree + 1):
        for e in blocks[d - 1]:
            et = tuple(int(v) for v in e)
            for i in range(nza):
                if et[i] == 0:
                    continue
                parent = et[:i] + (et[i] - 1,) + et[i + 1:]
                G[i::nza, pos[parent]] += A2[:, fr] * et[i]
            fr += 1
    pos_x = np.asarray(
        [pos[tuple(1 if k == j else 0 for k in range(nza))]
         for j in range(nza)], np.int64)
    return A1, G, blocks, tables, pos_x


class NonlinearKmpc(_KmpcBase):
    """SQP NMPC on the nonlinear realization (``NonlinearKmpc``,
    kmpc.py:1080-1676): ``sqp_iters`` passes, each
    linearizing the composed F along a trajectory, condensing the stage
    Jacobians into the factored QP with Levenberg damping rho and solving
    it by the interior point.  The controller takes the raw scaled outputs
    (it lifts [zeta; u] itself) and carries no duals across steps.

    It picks the JAX controller's route (``_solve_from``, :1352-1624):

    - **multipass** -- every pass in one launch of ``nmpc_multipass``
      (:1373-1401): the first pass about the held state ('hold', or the
      held plan's rollout with ``sqp_init='rollout'``), every later one
      along the rollout of the previous pass's plan, constant damping,
      cold duals.  Taken when no knob below asks for more.
    - **stage** -- one launch of ``nmpc_stage`` per pass with the pass's
      own rdiag and q0 (rho decays by ``sqp_damping_decay`` per pass) and
      the previous pass's multipliers with ``sqp_dual_warm``.  The kernel
      holds or rolls the trajectory itself ('hold'/'roll') unless
      ``sqp_linesearch`` or ``sqp_best_of_passes`` keep the rollout on the
      host for the merit; the trajectory then ships ('ship').
      ``sqp_multistart`` runs a second SQP from the shifted previous plan
      ``U_plan`` with its rollout shipped, and keeps the plan of lower
      true merit.
    - **chord** (``sqp_jac_period > 1``) -- the stage Jacobians formed on
      the host (``ops/nmpc.py:stage_lin``) every ``sqp_jac_period``
      passes and frozen in between, the defects fresh; one launch of
      ``nmpc_pass`` per pass.
    - **linear** (``sqp_update='linear'``, the infeasible-path update,
      :1352-1354, 1527-1564, 1599-1612) -- per pass ``stage_lin`` (frozen
      Jacobians between ``sqp_jac_period`` refreshes), the explicit
      condensation W, v in PyTorch on the device (``ops/nmpc.py:
      condense``) and one launch of ``ipm_factored``'s q0 build; the next
      pass linearizes along the state sequence of this pass's linearized
      dynamics under the new plan (``ops/nmpc.py:linear_rollout``), not
      along the nonlinear rollout, which runs only for the merit of
      ``sqp_best_of_passes`` or the line search.
    - **jacfwd** -- where no analytic poly Jacobian exists (JAX
      :1090-1118): a nonlinear model on any other dictionary (F composed
      as ``_compose_nonlinear_F``, :968-988: A1 x + A2 feats(x) + a0 over
      every family), or a bilinear model under ``mpc_type='nonlinear'``
      (F = C (A g(zeta) + Beta(g(zeta)) u), :1109-1116, ``Kmpc.m:93``).
      Each pass forms the stage Jacobians by forward-mode AD
      (``torch.func.jacfwd``, its tangents batched by ``vmap``, at all
      (stage, lane) points at once: ``stage_jacobians``; JAX
      :1289-1291), and runs one launch of the condensation-fused
      ``nmpc_pass`` (JAX ``solve_qp_nmpc``, :1520-1525); the next pass
      linearizes along the rollout of its plan through F on the device.  The other SQP knobs act as on the chord
      route ('linear': ``ipm_factored``).

    - **state_bounds** (``cfg.state_bounds`` on the unblocked stack, JAX
      :1476-1491) -- every pass along the trajectory of the routes above
      (the analytic or forward-mode Jacobians), the explicit condensation
      with the bounded coordinates' sensitivities (``ops/nmpc.py:
      state_bound_qp``) and a QP with a Hessian and rows a lane, solved by
      ``ops/qp.py:solve_qp_lane_A`` on the device (JAX's
      ``solve_qp(shared_A=False)``, which reaches no Pallas kernel).

    Each route runs under move blocking (``input_blocks``: the decision is
    one move a group, n=12 on the bench horizon) or unblocked (the default
    ``input_blocks=None`` and the reference's own NMPC, ``Kmpc.m:
    1114-1181``: every input of stages 1..Np-1, n=27), whose kernels are
    builds of their own.  Loaded models raise as in the JAX package.
    ``qp_dual_shift`` changes nothing here: the NMPC carries no duals
    across steps (as in the JAX package).

    Host constants (f64 numpy, as the JAX package): the composed maps
    ``A1``, ``A2``, ``a0``; the Jacobian generator ``G`` and ``pos_x``;
    the projection ``Cz``; the stage columns ``cols``; ``RdT``, ``bsizes``
    and from them ``rdiag`` = RdT + rho bsizes and ``q0c`` = -2 rho bsizes;
    ``Gup`` = tile(I_m); ``sqq`` = sqrt(Q).  Unblocked, Tb is the
    identity: ``RdT`` = Rd[m:], ``bsizes`` = 1.
    """

    def __init__(self, model, scaler, cfg: MpcConfig, device="cuda",
                 dtype=torch.float32):
        if model.meta.nw:
            # as the JAX controller (kmpc.py:1098-1103)
            raise NotImplementedError(
                "NMPC on loaded (nw > 0) models is not supported")
        bilinear = model.meta.model_type == "bilinear"
        if not (model.meta.model_type == "nonlinear"
                or bilinear and cfg.mpc_type == "nonlinear"):
            raise ValueError(
                "NonlinearKmpc takes a nonlinear model, or a bilinear one "
                "with mpc_type='nonlinear'")
        if cfg.sqp_iters < 1:
            raise NotImplementedError("sqp_iters < 1")
        super().__init__(model, scaler, cfg, device, dtype)
        m, n, Np = self.m, self.n, self.Np
        self.nz = self.meta.nzeta
        basis = model.basis
        nza = self.nz + m
        # the analytic Jacobian needs a nonlinear model on one poly family
        # of degree >= 2; every other dictionary takes the jacfwd route
        self.jacfwd = bilinear or not basis.single_poly \
            or basis.families[0][1] < 2
        t = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                                      device=self.device)
        if self.jacfwd:
            # the pass kernel reads the shipped Jacobians only: F's maps
            # are placeholders (an empty monomial table, zero maps)
            tables = ()
            self.A1, self.A2 = np.zeros((self.nz, nza)), \
                np.zeros((self.nz, 0))
            self.a0 = np.zeros(self.nz)
            Gc = np.zeros((nza * self.nz, -(-nza // 4) * 4))
            if bilinear:
                NL = self.NL
                for k, v in (("fA", model.A), ("fC", model.C),
                             ("fB", np.asarray(model.B)
                              .reshape(NL * m, NL))):
                    self.register_buffer(k, t(v))
            else:
                A1, A2, a0 = composed_maps(model)
                for k, v in (("fA1", A1), ("fA2", A2), ("fa0", a0)):
                    self.register_buffer(k, t(v))
        else:
            self.A1, self.A2, self.a0 = composed_maps(model)
            _, self.G, _, tables, self.pos_x = poly_jacobian_static(model)
            Gc = jacobian_generator(self.G, self.pos_x, self.nz, nza)
        # decision column of each stage's input block: [u_0 | group
        # moves], unblocked [u_0 | u_1 .. u_{Np-1}] (kmpc.py:1160-1168)
        if self.blocked:
            group_of = np.repeat(np.arange(len(cfg.input_blocks)),
                                 cfg.input_blocks)
            self.cols = tuple([0] + [m + int(group_of[k - 1]) * m
                                     for k in range(1, Np)])
            self.RdT = self.Tb.T @ self.r_diag[m:]
            self.bsizes = (self.Tb * self.Tb).sum(axis=0)
        else:
            self.cols = tuple(k * m for k in range(Np))
            self.RdT = self.r_diag[m:]
            self.bsizes = np.ones(self.RdT.size)
        self.Cz = self.projmtx[:, :n]
        rho = cfg.sqp_damping
        self.rdiag = self.RdT + rho * self.bsizes
        self.q0c = -2.0 * rho * self.bsizes
        self.Gup = np.tile(np.eye(m), (self.RdT.size // m, 1))
        self.sqq = np.sqrt(self.q_diag)
        self.hold0 = cfg.sqp_init != "rollout"
        # the route (_solve_from, kmpc.py:1354-1375, 1435-1437)
        self.jac_period = max(1, int(cfg.sqp_jac_period))
        self.linear_update = cfg.sqp_update == "linear"
        self.has_sb = cfg.state_bounds is not None
        self.roll_fused = (self.jac_period == 1 and not self.linear_update
                           and not cfg.sqp_best_of_passes
                           and cfg.sqp_linesearch == 0 and not self.jacfwd
                           and not self.has_sb)
        self.multipass = (self.roll_fused and not cfg.sqp_dual_warm
                          and cfg.sqp_damping_decay == 1.0)
        qp = nmpc_qp_operands(
            self.A1, self.A2, self.a0, Gc, tables, self.Cz, self.sqq, self.cols, self.rdiag, self.q0c, self.Gup,
            self.F_red, self.cF_red, self.F0_red, self.band, dtype=dtype,
            device=self.device)
        self._qp_static = {k: getattr(qp, k) for k in
                           ("tables_host", "cols", "n", "mc", "m", "nz",
                            "nproj", "band")}
        for k in ("A1", "A2", "a0", "G", "Gup", "q0c", "CzS", "rdiag"):
            self.register_buffer(k + "_t", getattr(qp, k))
        for k, v in (("RdT_t", self.RdT), ("bsizes_t", self.bsizes),
                     ("Rd_t", self.r_diag), ("cF_t", self.cF_red),
                     ("F0_t", self.F0_red)):
            self.register_buffer(k, t(v))
        if self.has_sb:
            # the bounded coordinates' limits in scaled units and the
            # input rows with u_0's columns (kmpc.py:1184-1186, 1484-1486)
            lo, hi = state_bound_values(cfg, n, scaler)
            for k, v in (("sb_lo_t", lo), ("sb_hi_t", hi),
                         ("F_t", self.F)):
                self.register_buffer(k, t(v))

    @property
    def route(self) -> str:
        """The route of a step's first SQP ('multipass', 'stage', 'chord',
        'jacfwd', 'linear' or 'state_bounds'); multistart's second SQP
        always takes the per-pass loop."""
        if self.multipass:
            return "multipass"
        if self.has_sb:
            return "state_bounds"
        if self.linear_update:
            return "linear"
        if self.jacfwd:
            return "jacfwd"
        return "stage" if self.jac_period == 1 else "chord"

    # ----------------------------------------------- dynamics and Jacobians

    def dynamics(self, z, u) -> torch.Tensor:
        """The controller's dynamics F(z, u) on lanes-minor z (nz, B) and
        u (m, B): (nz, B) -- the composed poly map (``ops/nmpc.py:
        eval_F``), the composed map over every family (jacfwd route,
        ``_compose_nonlinear_F``) or C (A g + Beta(g) u) of a bilinear
        model's lift g of z."""
        if not self.jacfwd:
            return eval_F(self.nmpc_qp(), z, u)
        if self.meta.model_type == "bilinear":
            g = self.lift_econ(z)
            NL, B = self.NL, z.shape[1]
            beta = (self.fB @ g).reshape(NL, self.m, B)
            return self.fC @ (self.fA @ g
                              + torch.einsum("kmb,mb->kb", beta, u))
        x = torch.cat([z, u])
        feats = lift_full_with(self.model.basis.families,
                               self.lift_operands(), x)[x.shape[0]:-1]
        return self.fA1 @ x + self.fA2 @ feats + self.fa0[:, None]

    # forward-mode Jacobians in chunks of at most this many points
    JAC_CHUNK = 1 << 18

    def stage_jacobians(self, Zl, Ul) -> torch.Tensor:
        """Stage Jacobians of F along a trajectory Zl (Np, nz, B) and plan
        Ul (Np*m, B) (any number of stages) by forward-mode AD (JAX ``_stage_lin``, kmpc.py:
        1289-1291, ``jax.jacfwd`` at each point under ``vmap``): F acts
        column by column, so ``torch.func.jacfwd`` of F(X + d 1^T) in a
        shift d (nza,) shared by the Np*B points, at d = 0, gives every
        point's Jacobian at once, its nza tangents batched by
        ``torch.func.vmap`` over lanes-minor columns.  Returns Jt
        (Np, nza, nz, B) with Jt[k, i, o] = dF_o/dx_i, the kernels' column
        order."""
        Np, nz, m = Zl.shape[0], self.nz, self.m
        B = Zl.shape[-1]
        Z = Zl.transpose(0, 1).reshape(nz, Np * B)
        U = Ul.reshape(Np, m, B).transpose(0, 1).reshape(m, Np * B)
        d0 = Z.new_zeros(nz + m)
        parts = []
        for a in range(0, Np * B, self.JAC_CHUNK):
            Zc, Uc = Z[:, a:a + self.JAC_CHUNK], U[:, a:a + self.JAC_CHUNK]
            shifted = lambda d: self.dynamics(Zc + d[:nz, None],
                                              Uc + d[nz:, None])
            parts.append(torch.func.jacfwd(shifted)(d0))   # (o, pts, i)
        J = torch.cat(parts, dim=1).reshape(nz, Np, B, nz + m)
        return J.permute(1, 3, 0, 2).contiguous()

    def stage_lin(self, Zl, Ul, frozen=None, Fv=None):
        """(Jt, cv) of a trajectory (``ops/nmpc.py:stage_lin``): the
        analytic Jacobians, or on the jacfwd route ``stage_jacobians``;
        with ``frozen`` an earlier pass's Jt, the defects fresh with Fv =
        F(Zl, Ul) formed where not given."""
        if not self.jacfwd:
            return stage_lin(self.nmpc_qp(), Zl, Ul, frozen=frozen, Fv=Fv)
        Np, nz, m = self.Np, self.nz, self.m
        B = Zl.shape[-1]
        Ur = Ul.reshape(Np, m, B)
        if frozen is not None:
            Jt = frozen
        elif Zl.stride(0) == 0 and torch.equal(Ur, Ur[:1].expand_as(Ur)):
            # the held start: every stage at the one point (zeta, u_prev)
            Jt = self.stage_jacobians(Zl[:1], Ul[:m]).expand(
                (Np, nz + m, nz, B)).contiguous()
        else:
            Jt = self.stage_jacobians(Zl, Ul)
        if Fv is None:
            flat = lambda a: a.transpose(0, 1).reshape(a.shape[1], Np * B)
            Fv = self.dynamics(flat(Zl), flat(Ur)).reshape(nz, Np, B) \
                .transpose(0, 1)
        return Jt, defects(Fv, Jt, Zl, Ur).contiguous()

    def moves(self, U) -> torch.Tensor:
        """The decision of a plan U (Np*m, B) without u_0: one move a group
        Sel U[m:] under move blocking, U[m:] unblocked (the SQP passes'
        primal start, kmpc.py:1500-1510)."""
        return self.Sel_t @ U[self.m:] if self.blocked else U[self.m:]

    def levenberg_q0(self, U, rho: float) -> torch.Tensor:
        """The Levenberg term's linear part about the plan U,
        -2 rho Tb^T U[m:] (-2 rho U[m:] unblocked)."""
        Ur = U[self.m:]
        return -2.0 * rho * (self.Tb_t.T @ Ur if self.blocked else Ur)

    def nmpc_qp(self, rdiag=None) -> NmpcQP:
        """The solve's operands as an ``NmpcQP`` view of this module's
        buffers; ``rdiag`` (n,) replaces the multipass route's."""
        return NmpcQP(
            **{k: getattr(self, k + "_t") for k in
               ("A1", "A2", "a0", "G", "Gup", "q0c", "CzS")},
            rdiag=self.rdiag_t if rdiag is None else rdiag,
            A=self.A, cFr=self.cFr, F0r=self.F0r, row=self.row, Wd=self.Wd,
            Wo=self.Wo, tables=self.poly_tables(), **self._qp_static)

    def solve(self, zeta, u_prev, sqYr, U_plan=None):
        """One batched SQP solve (``NonlinearKmpc.solve``, kmpc.py:1325),
        lanes-minor: zeta (nz, B) the raw scaled outputs, u_prev (m, B) the
        scaled previous input, sqYr (p,) or (p, B) the sqrt(Q)-scaled
        reference window, U_plan (Np*m, B) the previous plan.  Every SQP
        starts cold from the held input, as the JAX controller does;
        ``U_plan`` is read only by ``sqp_multistart``, whose second SQP
        starts from it shifted by one stage and linearizes along its
        rollout, the plan of lower true merit winning lane by lane.
        Returns the plan U (Np*m, B) and the ``QPSolution`` of the pass it
        came from (ok of the multistart: either SQP's)."""
        held = u_prev.repeat(self.Np, 1)
        if not (self.cfg.sqp_multistart and U_plan is not None):
            return self._solve_from(zeta, u_prev, sqYr, held)
        m = self.m
        U1, sol1 = self._solve_from(zeta, u_prev, sqYr, held)
        shifted = torch.cat([U_plan[m:], U_plan[-m:]])
        Zw = self._rollout_full(zeta, shifted)
        U2, sol2 = self._solve_from(zeta, u_prev, sqYr, shifted, Zl=Zw[:-1],
                                    Fv=Zw[1:])
        c1 = torch.where(sol1.ok, self._roll_cost(zeta, U1, sqYr), INF)
        c2 = torch.where(sol2.ok, self._roll_cost(zeta, U2, sqYr), INF)
        take2 = c2 < c1
        sol = _pick(take2, sol2, sol1)
        return torch.where(take2, U2, U1), sol._replace(ok=sol1.ok | sol2.ok)

    def _solve_from(self, zeta, u_prev, sqYr, Ul, Zl=None, Fv=None):
        """The SQP from the plan Ul (Np*m, B), optionally along a given
        trajectory Zl with dynamics values Fv (Np, nz, B)
        (``_solve_from``, kmpc.py:1352-1624).  Returns (U,
        QPSolution)."""
        cfg, m, Np = self.cfg, self.m, self.Np
        qp0 = self.nmpc_qp()
        if self.multipass and Zl is None:
            sol = solve_qp_nmpc_multipass(qp0, zeta, u_prev, sqYr,
                                          cfg.sqp_iters, self.hold0,
                                          cfg.qp_iters)
            return self.plan(u_prev, sol.x), sol
        mode0 = "ship"
        if Zl is None:
            if self.roll_fused:
                mode0 = "hold" if self.hold0 else "roll"
            elif not self.hold0:
                Z = self._rollout_full(zeta, Ul)
                Zl, Fv = Z[:-1], Z[1:]
            else:
                Zl = zeta.expand((Np,) + zeta.shape)
        best = None
        lam_carry = None
        frozen = None
        stages = self.jac_period == 1 and not self.linear_update \
            and not self.jacfwd and not self.has_sb
        for it in range(cfg.sqp_iters):
            if stages:
                mode = (mode0 if it == 0 else "roll") if self.roll_fused \
                    else "ship"
                if mode == "ship" and Fv is None:
                    # the cold 'hold' start: every stage's dynamics value
                    # is the one evaluation at the current point
                    F0 = self.dynamics(Zl[0], Ul[:m])
                    Fv = F0.expand((Np,) + F0.shape)
            elif it % self.jac_period == 0:
                Jt, cv = self.stage_lin(Zl, Ul, Fv=Fv)
                frozen = Jt
            else:
                Jt, cv = self.stage_lin(Zl, Ul, frozen=frozen, Fv=Fv)
            rho = cfg.sqp_damping * (cfg.sqp_damping_decay ** it)
            qp = self.nmpc_qp(self.RdT_t + rho * self.bsizes_t)
            x0 = self.moves(Ul)
            q0 = None if rho == 0.0 else self.levenberg_q0(Ul, rho)
            if self.has_sb:
                sol = solve_qp_lane_A(*state_bound_qp(
                    qp, Jt, cv, zeta, u_prev, sqYr, q0, self.sb_lo_t,
                    self.sb_hi_t, self.F_t, self.cF_t), iters=cfg.qp_iters,
                    x0=x0, lam0=lam_carry)
            elif self.linear_update:
                # the explicit condensation, then the factored QP with the
                # Levenberg term as q0 (kmpc.py:1527-1564)
                W, v = condense(qp, Jt, cv, zeta, u_prev, sqYr)
                sol = solve_qp_factored(
                    W, v, qp.rdiag, self.constraints(),
                    self.cF_t[:, None] - self.F0_t @ u_prev, x0=x0,
                    lam0=lam_carry, iters=cfg.qp_iters, q0=q0)
            elif stages:
                ship = mode == "ship"
                sol = solve_qp_nmpc_stages(
                    qp, mode, zeta, u_prev, sqYr, x0=x0, q0=q0,
                    lam0=lam_carry, iters=cfg.qp_iters,
                    Zl=Zl if ship else None,
                    Ul=Ul if mode != "hold" else None,
                    Fv=Fv if ship else None)
            else:
                sol = solve_qp_nmpc_pass(qp, Jt, cv, zeta, u_prev, sqYr,
                                         x0=x0, q0=q0, lam0=lam_carry,
                                         iters=cfg.qp_iters)
            U_qp = self.plan(u_prev, sol.x)
            if cfg.sqp_dual_warm:
                lam_carry = sol.lam
            last = it == cfg.sqp_iters - 1
            Zroll, cost = None, None
            if cfg.sqp_linesearch > 0:
                U, Zroll, cost = self._line_search(zeta, Ul, U_qp, sqYr)
            else:
                U = U_qp
                if cfg.sqp_best_of_passes or (
                        not last and not self.roll_fused
                        and not self.linear_update):
                    Zroll = self._rollout_full(zeta, U)
            if cfg.sqp_best_of_passes:
                if cost is None:
                    cost = self._cost_from_Z(Zroll, U, sqYr)
                cost = torch.where(sol.ok, cost, INF)
                if best is None:
                    best = (U, cost, sol)
                else:
                    take = cost < best[1]
                    best = (torch.where(take, U, best[0]),
                            torch.minimum(cost, best[1]),
                            _pick(take, sol, best[2]))
            if not last:
                if self.linear_update:
                    # the infeasible-path update: along the linearized
                    # dynamics, defects open between passes
                    Zl = linear_rollout(qp0, Jt, cv, zeta, U, self.Sel_t)
                    Fv = None
                elif self.roll_fused:
                    Zl = Fv = None
                else:
                    Zl, Fv = Zroll[:-1], Zroll[1:]
            Ul = U
        if cfg.sqp_best_of_passes:
            return best[0], best[2]
        return U, sol

    def _rollout_full(self, zeta, U):
        """Exact nonlinear rollout of a plan: Z = [z_0 .. z_Np]
        (``_rollout_full``, kmpc.py:1626)."""
        if not self.jacfwd:
            return rollout(self.nmpc_qp(), zeta, U)
        m, Z = self.m, [zeta]
        for k in range(self.Np):
            Z.append(self.dynamics(Z[-1], U[k * m:(k + 1) * m]))
        return torch.stack(Z)

    def _cost_from_Z(self, Z, U, sqYr):
        """Merit of a plan given its exact rollout (``_cost_from_Z``,
        kmpc.py:1642): (B,)."""
        return merit(self.nmpc_qp(), Z, U, sqYr, self.Rd_t)

    def _roll_cost(self, zeta, U, sqYr):
        """True merit of a plan: its rollout's cost (``_roll_cost``,
        kmpc.py:1648)."""
        return self._cost_from_Z(self._rollout_full(zeta, U), U, sqYr)

    def _line_search(self, zeta, U_old, U_qp, sqYr):
        """Backtracking merit line search between the previous plan and
        the QP step (``_line_search``, kmpc.py:1658): the candidates
        U_old + alpha (U_qp - U_old), alpha = 1, 1/2, .. 2^-ls, roll out
        together (as extra lanes) and the lowest merit wins lane by lane
        (the first on ties, NaN as lowest: ``jnp.argmin``).  Returns
        (U, Z, cost) of the winners."""
        ls = self.cfg.sqp_linesearch
        B = zeta.shape[1]
        alphas = [1.0] + [0.5 ** i for i in range(1, ls + 1)]
        K = len(alphas)
        step = U_qp - U_old
        cands = torch.cat([U_old + a * step for a in alphas], dim=1)
        Zs = self._rollout_full(zeta.repeat(1, K), cands)
        sq = sqYr.repeat(1, K) if sqYr.ndim == 2 else sqYr
        costs = self._cost_from_Z(Zs, cands, sq).reshape(K, B)
        i = torch.argmin(costs, dim=0)                          # (B,)
        lane = torch.arange(B, device=zeta.device)
        pick = lambda a: a.reshape(a.shape[:-1] + (K, B))[..., i, lane]
        return pick(cands), pick(Zs), costs[i, lane]


def _pick(take, a: QPSolution, b: QPSolution) -> QPSolution:
    """Lane by lane, solution a where ``take``, else b."""
    return QPSolution(*(torch.where(take, u, v) for u, v in zip(a, b)))


def make_kmpc(model, scaler, cfg: MpcConfig, device="cuda",
              dtype=torch.float32):
    """The controller of a model and ``cfg.mpc_type`` (JAX ``make_kmpc``,
    kmpc.py:1678-1690; ``Kmpc.m:85-103``): linear model -> ``LinearKmpc``,
    bilinear -> ``BilinearKmpc``, or ``NonlinearKmpc`` under
    ``mpc_type='nonlinear'``, nonlinear -> ``NonlinearKmpc`` whatever
    ``mpc_type`` says (as the JAX factory)."""
    mt = model.meta.model_type
    mpc_type = cfg.mpc_type or ("nonlinear" if mt == "nonlinear"
                                else "linear")
    if mt == "linear" and mpc_type == "linear":
        return LinearKmpc(model, scaler, cfg, device, dtype)
    if mt == "bilinear" and mpc_type == "linear":
        return BilinearKmpc(model, scaler, cfg, device, dtype)
    if mt == "bilinear" and mpc_type == "nonlinear" or mt == "nonlinear":
        return NonlinearKmpc(model, scaler, cfg, device, dtype)
    raise ValueError(f"{mt} model is incompatible with mpc_type {mpc_type}")
