"""Plain lanes-minor math of the SQP NMPC solves.

The plain PyTorch counterpart of the device functions of
``csrc/nmpc_device.cuh`` and of the JAX package's NMPC code: the composed
dynamics F (``_eval_F_rows``, ``ops/pallas/qp_ipm.py:1397``;
``_stage_roll_xla``, ``ops/qp.py:811``), the analytic stage Jacobians
(``_stage_jacs_xla``, ``ops/qp.py:849``; ``_stage_lin``,
``control/kmpc.py:1277``), the defects, the sensitivity condensation and
W/v assembly (``_nmpc_condense_core``, qp_ipm.py:1082;
``_nmpc_condense_assemble``, ops/qp.py:539), the linearized dynamics'
state sequence (the 'linear' between-pass update, control/kmpc.py:
1599-1612), the nonlinear rollout and its
merit (``NonlinearKmpc._rollout_full`` / ``_cost_from_Z``,
control/kmpc.py:1626-1646) and the three kinds of SQP solve the kernels
run: one pass from shipped stage Jacobians (``_nmpc_kernel``,
qp_ipm.py:1144; pure path ops/qp.py:602-608), one pass with the
Jacobians formed from a held, rolled or shipped trajectory
(``_nmpc_stage_kernel``, qp_ipm.py:1560; pure path ops/qp.py:936-949) and
every pass of a step (``_nmpc_multipass_pure``, ops/qp.py:1119; the
kernel body qp_ipm.py:1478-1557).  Each pass ends in the port's factored
Gram, objective scale and Mehrotra loop (``ops/qp.py``).

Layout: the batch is the LAST axis, as in ``ops/qp.py``.  The dynamics are
F(x) = A1 x + A2 mono(x) + a0 with x = [zeta; u] and mono(x) the
degree-blocked monomials of degree 2..d; the Jacobian is
J(x) = A1 + unflatten(G g_low(x)) with g_low = [x; monomials of degree
2..d-1].  G is used whole: the JAX package ships it as a bf16 hi/lo pair,
which carries ~2^-16 of relative error.  The monomials are index gathers
(no one-hot selection GEMMs).  A plan U is (Np*m, B) (stage k's input in
rows k*m..), a trajectory Zl or Fv (Np, nz, B), and the stage Jacobians
of a pass Jt (Np, nza, nz, B) with Jt[k, i, o] = dF_o/dx_i at stage k
(the kernels' column order).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from koopman_realizations_torch.ops.observables import poly_features
from koopman_realizations_torch.ops.qp import (
    Constraints,
    QPSolution,
    constraint_tables,
    diag_obj_scale,
    factored_gram,
    mehrotra_loop,
    ok_mask,
    qp_constants,
)

# the pass loop's slack floor: every pass starts from the previous one's
# primal (qp_ipm.py:1550, hard-coded there as here)
SLACK_FLOOR = 1e-2


class NmpcQP(NamedTuple):
    """Lane-shared operands of the whole-SQP NMPC solve.

    ``A1`` (nz, nza), ``A2`` (nz, nmono) and ``a0`` (nz,) compose F; ``G``
    (nza*nz, nlowp) is the Jacobian generator with rows in column-major
    order (row i*nz + o holds dF_o/dx_i, as ``build_stage_jac_ops``,
    ops/qp.py:702) and columns [x | monomials of degree 2..d-1 | 0-pad to
    a multiple of 4]; ``Gup`` (n, m) tiles u_prev into the pass-0 plan,
    ``q0c`` (n,) is the Levenberg coefficient -2 rho bsizes, ``CzS``
    (p, ns) the sqrt(Q)-scaled output projection over the horizon,
    ``rdiag`` (n,) the blocked input cost plus rho bsizes.  A, cFr, F0r,
    row, Wd, Wo are the row-equilibrated constraints as in ``LiftQP``;
    ``cols`` the decision column each stage's input block enters.
    """

    A1: torch.Tensor
    A2: torch.Tensor
    a0: torch.Tensor
    G: torch.Tensor
    Gup: torch.Tensor
    q0c: torch.Tensor
    CzS: torch.Tensor
    rdiag: torch.Tensor
    A: torch.Tensor
    cFr: torch.Tensor
    F0r: torch.Tensor
    row: torch.Tensor
    Wd: torch.Tensor
    Wo: torch.Tensor
    tables: Tuple[Tuple[torch.Tensor, torch.Tensor], ...]
    tables_host: tuple        # the same (parent, dim) index tables as ints
    cols: Tuple[int, ...]
    n: int
    mc: int
    m: int
    nz: int
    nproj: int
    band: Optional[int]

    @property
    def nza(self) -> int:
        return self.nz + self.m

    @property
    def Np(self) -> int:
        return len(self.cols)

    @property
    def p(self) -> int:
        return self.CzS.shape[0]

    @property
    def ns(self) -> int:
        return self.CzS.shape[1]

    @property
    def nlow(self) -> int:
        """Width of g_low: x and the monomial blocks below the top
        degree."""
        return self.nza + sum(len(par) for par, _ in self.tables_host[:-1])

    @property
    def nmono(self) -> int:
        return self.A2.shape[1]

    @property
    def cons(self) -> Constraints:
        return Constraints(self.A, self.row, self.Wd, self.Wo, self.n,
                           self.mc, self.band)


def jacobian_generator(G, pos_x, nz: int, nza: int) -> np.ndarray:
    """The kernel's layout of the analytic Jacobian's generator (f64): the
    rows of ``G`` ((o, i) = o*nza + i, ``poly_jacobian_static``) in
    column-major order i*nz + o, its x columns in coordinate order
    (``pos_x``), then the monomial columns, zero-padded to a multiple of
    4 columns."""
    G = np.asarray(G, np.float64)
    perm = np.array([o * nza + i for i in range(nza) for o in range(nz)])
    cols = np.concatenate([np.asarray(pos_x, np.int64),
                           np.arange(nza, G.shape[1])])
    Gc = G[perm][:, cols]
    ncp = -(-Gc.shape[1] // 4) * 4
    out = np.zeros((Gc.shape[0], ncp))
    out[:, :Gc.shape[1]] = Gc
    return out


def nmpc_qp_operands(A1, A2, a0, Gc, tables, Cz, sq, cols, rdiag, q0c, Gup,
                     F_red, cF_red, F0_red, band, *, device,
                     dtype=torch.float32) -> NmpcQP:
    """Device operands from the controller's f64 host constants, on
    ``device`` (no default, so that no operand silently lands on the
    CPU): the row equilibration, CzS = sq * tile(Cz) and the banded
    A^T D A tables, as the JAX wrapper forms them (qp_ipm.py:1759-1776).
    ``Gc`` is ``jacobian_generator``'s layout, ``tables`` the
    ``poly_parent_tables`` pairs over nza."""
    F_red = np.asarray(F_red, np.float64)
    Cz = np.asarray(Cz, np.float64)
    Np1 = np.asarray(sq).size // Cz.shape[0]
    CzS = np.asarray(sq, np.float64)[:, None] * np.tile(Cz, (Np1, 1))
    row, A_eq, Wd, Wo = constraint_tables(F_red, band)
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                                  device=device)
    idx = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.long,
                                    device=device)
    return NmpcQP(
        A1=t(A1), A2=t(A2), a0=t(np.asarray(a0).reshape(-1)), G=t(Gc),
        Gup=t(Gup), q0c=t(q0c), CzS=t(CzS), rdiag=t(rdiag), A=t(A_eq),
        cFr=t(np.asarray(cF_red) / row),
        F0r=t(np.asarray(F0_red) / row[:, None]), row=t(row), Wd=t(Wd),
        Wo=t(Wo),
        tables=tuple((idx(pi), idx(di)) for pi, di in tables),
        tables_host=tuple((tuple(int(v) for v in pi),
                           tuple(int(v) for v in di)) for pi, di in tables),
        cols=tuple(int(c) for c in cols), n=F_red.shape[1],
        mc=F_red.shape[0], m=np.asarray(Gup).shape[1],
        nz=np.asarray(A1).shape[0], nproj=Cz.shape[0], band=band)


# ------------------------------------------------------------ dynamics


def eval_F(qp: NmpcQP, z, u):
    """The composed dynamics F(z, u) for lanes-minor z (nz, B) and
    u (m, B): (nz, B)."""
    x = torch.cat([z, u])
    return qp.A1 @ x + qp.A2 @ poly_features(x, qp.tables) + qp.a0[:, None]


def stage_jacobian(qp: NmpcQP, z, u):
    """Analytic Jacobian of F at (z, u) in the kernels' column order:
    J (nza, nz, B) with J[i, o] = dF_o / dx_i."""
    x = torch.cat([z, u])
    g = torch.cat([x, poly_features(x, qp.tables[:-1])])
    Jc = qp.G[:, :qp.nlow] @ g                          # (nza*nz, B)
    return qp.A1.T[..., None] + Jc.reshape(qp.nza, qp.nz, -1)


def defects(F, J, zl, ul):
    """cv = F(zl, ul) - Jz zl - Ju ul: the affine term of the
    linearization at (zl, ul), for J (..., nza, nz, B) in the kernels'
    column order and any leading (stage) dimensions."""
    nz = zl.shape[-2]
    return F - torch.einsum("...iob,...ib->...ob", J[..., :nz, :, :], zl) \
        - torch.einsum("...job,...jb->...ob", J[..., nz:, :, :], ul)


def rollout(qp: NmpcQP, zeta, U):
    """Exact nonlinear rollout of the plan U (Np*m, B) from zeta (nz, B):
    Z = [z_0 .. z_Np] (Np+1, nz, B); Z[:-1] is the next pass's
    linearization trajectory and Z[1:] its dynamics values F(Z[:-1], U)."""
    m = qp.m
    Z = [zeta]
    for k in range(qp.Np):
        Z.append(eval_F(qp, Z[-1], U[k * m:(k + 1) * m]))
    return torch.stack(Z)


def merit(qp: NmpcQP, Z, U, sqRef, Rd):
    """True merit of a plan U (Np*m, B) on its rollout Z (Np+1, nz, B):
    the Q-weighted tracking over the horizon plus the R-weighted input,
    sum_r (CzS_r z - sqRef_r)^2 + Rd . U^2 with sqRef = sqrt(Q) Yr (p,)
    or (p, B) and Rd (Np*m,) the input cost: (B,)."""
    Np1, ns, nproj = qp.Np + 1, qp.ns, qp.nproj
    Y = torch.einsum("krs,ksb->krb", qp.CzS.reshape(Np1, nproj, ns),
                     Z[:, :ns]).reshape(Np1 * nproj, -1)
    sq = sqRef if sqRef.ndim == 2 else sqRef[:, None]
    return ((Y - sq) ** 2).sum(0) + (Rd[:, None] * U * U).sum(0)


def stage_lin(qp: NmpcQP, Zl, Ul, frozen=None, Fv=None):
    """Per-stage linearization of a trajectory without the condensation:
    Zl (Np, nz, B), Ul (Np*m, B) -> (Jt (Np, nza, nz, B), cv (Np, nz, B)).
    With ``frozen`` (an earlier pass's Jt) the Jacobians are reused; the
    defects cv = Fv - Jz Zl - Ju Ul are always fresh at the new point, with
    Fv = F(Zl, Ul) formed here when not given."""
    Np, nz, m = qp.Np, qp.nz, qp.m
    B = Zl.shape[-1]
    Ur = Ul.reshape(Np, m, B)
    flat = lambda a: a.transpose(0, 1).reshape(a.shape[1], Np * B)
    if frozen is None:
        Jt = stage_jacobian(qp, flat(Zl), flat(Ur))
        Jt = Jt.reshape(qp.nza, nz, Np, B).permute(2, 0, 1, 3)
    else:
        Jt = frozen
    if Fv is None:
        Fv = eval_F(qp, flat(Zl), flat(Ur)).reshape(nz, Np, B) \
            .transpose(0, 1)
    return Jt.contiguous(), defects(Fv, Jt, Zl, Ur).contiguous()


# ------------------------------------------------------- condensation


def sweep(qp: NmpcQP, Jt, cv, zeta):
    """The sensitivity recursion over the horizon of the stage Jacobians
    Jt (Np, nza, nz, B) and defects cv (Np, nz, B): yields (S_k, s_k) for
    k = 0..Np with zeta_k = s_k + S_k Uvec over the decision columns
    [u_0 | moves] (nz, m + n, B): S_0 = 0, s_0 = zeta; S_{k+1} = Jz_k S_k
    + Ju_k at stage k's columns, s_{k+1} = Jz_k s_k + cv_k."""
    nz, m = qp.nz, qp.m
    S = zeta.new_zeros((nz, m + qp.n, zeta.shape[1]))
    s = zeta
    for k in range(qp.Np + 1):
        yield S, s
        if k < qp.Np:
            S = torch.einsum("iob,icb->ocb", Jt[k, :nz], S)
            c0 = qp.cols[k]
            S[:, c0:c0 + m] += Jt[k, nz:].transpose(0, 1)
            s = torch.einsum("iob,ib->ob", Jt[k, :nz], s) + cv[k]


def condense(qp: NmpcQP, Jt, cv, zeta, up, sqRef):
    """Sensitivity condensation and W/v assembly over the horizon
    (``sweep``): stage k's projected rows CzS_k [S_k | s_k] give W (its
    decision columns) and v (the affine part, the reference subtracted and
    the pinned u_prev folded in).  sqRef is (p,) or (p, B).  Returns
    (W (p, n, B), v (p, B))."""
    m, ns, nproj = qp.m, qp.ns, qp.nproj
    sq = sqRef if sqRef.ndim == 2 else sqRef[:, None]
    W_rows, v_rows = [], []
    for k, (S, s) in enumerate(sweep(qp, Jt, cv, zeta)):
        Ck = qp.CzS[k * nproj:(k + 1) * nproj]          # (nproj, ns)
        Pk = torch.einsum("ri,icb->rcb", Ck, S[:ns])
        vk = Ck @ s[:ns] - sq[k * nproj:(k + 1) * nproj] \
            + torch.einsum("rjb,jb->rb", Pk[:, :m], up)
        W_rows.append(Pk[:, m:])
        v_rows.append(vk)
    return torch.cat(W_rows), torch.cat(v_rows)


def state_bound_qp(qp: NmpcQP, Jt, cv, zeta, up, sqRef, q0, lo, hi, F, cF):
    """One SQP pass's QP with state-bound rows, a Hessian and rows a lane
    (the JAX controller's ``E.shape[0]`` branch, control/kmpc.py:
    1476-1491, which solves it by ``solve_qp(shared_A=False)``):
    P = 2 (W^T W + diag(rdiag)) and f = 2 W^T v + q0 of the condensation
    (JAX's 2 H[m:, m:] and f[m:] + 2 H[m:, :m] u_prev with H = Sy^T Q Sy +
    diag(Rd) + rho I), the input rows F (mc, m + n) with cF (mc,) in
    original units and, for stages 2..Np, [-S_k; S_k]
    over the first nb = lo.numel() coordinates with b = [s_k - lo;
    hi - s_k], u_prev's columns moved to b.  lo, hi (nb,) are the bounds in
    scaled units; q0 (n, B) or None.  Returns (P (n, n, B), f (n, B),
    A (mc', n, B), b (mc', B)) with mc' = mc + 2 nb (Np - 1)."""
    m, nb, B = qp.m, lo.numel(), zeta.shape[1]
    W, v = condense(qp, Jt, cv, zeta, up, sqRef)
    P = 2.0 * (torch.einsum("rib,rjb->ijb", W, W)
               + torch.diag(qp.rdiag)[..., None])
    f = 2.0 * torch.einsum("rib,rb->ib", W, v)
    if q0 is not None:
        f = f + q0
    states = list(sweep(qp, Jt, cv, zeta))[2:]
    Sn = torch.stack([S[:nb] for S, _ in states])       # (Np-1, nb, m+n, B)
    sn = torch.stack([s[:nb] for _, s in states])       # (Np-1, nb, B)
    LE = torch.stack([-Sn, Sn], dim=1).reshape(-1, m + qp.n, B)
    bE = torch.stack([sn - lo[:, None], hi[:, None] - sn], dim=1) \
        .reshape(-1, B)
    Fz = F[:, m:]
    A = torch.cat([Fz[..., None].expand(*Fz.shape, B), LE[:, m:]])
    b = torch.cat([cF[:, None] - F[:, :m] @ up,
                   bE - torch.einsum("cjb,jb->cb", LE[:, :m], up)])
    return P, f, A.contiguous(), b


def linear_rollout(qp: NmpcQP, Jt, cv, zeta, U, Sel=None):
    """The state sequence of a pass's linearized dynamics under the plan U
    (Np*m, B): z_0 = zeta, z_{k+1} = Jz_k z_k + Ju_k u_k + cv_k with stage
    k's input u_k taken from Uvec = [U_0; Sel U[m:]] at the stage's
    decision column (``Sel`` None: U[m:] as it is); returns
    [z_0 .. z_{Np-1}] (Np, nz, B), the next pass's linearization
    trajectory of the 'linear' between-pass update.  Equal by construction
    to the explicit condensation's (sz + Sz Uvec)[:-1] with the full
    nz-row sensitivity stack (``_condense_inner`` with keep = nz,
    control/kmpc.py:1238-1275, 1599-1612), without storing the
    (Np+1, nz, nU, B) stack."""
    nz, m = qp.nz, qp.m
    Uv = torch.cat([U[:m], U[m:] if Sel is None else Sel @ U[m:]])
    Z = [zeta]
    for k in range(qp.Np - 1):
        c0 = qp.cols[k]
        Z.append(torch.einsum("iob,ib->ob", Jt[k, :nz], Z[-1])
                 + torch.einsum("job,jb->ob", Jt[k, nz:], Uv[c0:c0 + m])
                 + cv[k])
    return torch.stack(Z)


# ------------------------------------------------------------ solves


def rhs(qp: NmpcQP, up):
    """b = cFr - F0r u_prev (mc, B), row-equilibrated."""
    return qp.cFr[:, None] - qp.F0r @ up


def pass_qp(qp: NmpcQP, W, v, b, x0, q0, lam0_row, iters: int,
            slack_floor: float):
    """One pass's QP from its condensed W (p, n, B) and v (p, B): the
    factored Gram P = 2 (W^T W + diag(rdiag)), q = 2 W^T v (+ q0), the
    objective scale, the regularization and the Mehrotra loop from x0 with
    the dual start lam = 1 (``lam0_row`` None) or
    sqrt(clip(lam0_row / obj, 1e-4, 1e4)) (``lam0_row`` in
    row-equilibrated units, ``_nmpc_kernel`` :1217-1220).  Returns
    (x, s, lam, obj)."""
    c = qp_constants(W.dtype)
    P, qv = factored_gram(W.reshape(-1, W.shape[-1]), v, qp.rdiag, qp.p,
                          qp.n)
    if q0 is not None:
        qv = qv + q0
    obj = diag_obj_scale(P)
    iobj = 1.0 / obj
    eye = torch.eye(qp.n, dtype=W.dtype, device=W.device)[..., None]
    lam0 = torch.ones_like(b) if lam0_row is None \
        else torch.sqrt(torch.clamp(lam0_row * iobj, 1e-4, 1e4))
    x, s, lam = mehrotra_loop(qp.cons, iters, slack_floor,
                              P * iobj + c.reg * eye, qv * iobj, b, x0, lam0,
                              c.mu_floor)
    return x, s, lam, obj


def jacobian_pass(qp: NmpcQP, Jt, cv, zeta, up, sqRef, x0, q0, lam0_row,
                  iters: int, slack_floor: float):
    """One SQP pass from shipped stage Jacobians Jt (Np, nza, nz, B) and
    defects cv (Np, nz, B): the condensation, then ``pass_qp`` with
    ``qp.rdiag``; the plain version of csrc/nmpc_pass.cu.  Returns
    (x, s, lam, obj)."""
    W, v = condense(qp, Jt, cv, zeta, up, sqRef)
    return pass_qp(qp, W, v, rhs(qp, up), x0, q0, lam0_row, iters,
                   slack_floor)


STAGE_MODES = ("ship", "hold", "roll")


def stage_linearization(qp: NmpcQP, mode: str, zeta, up, Zl=None, Ul=None,
                        Fv=None):
    """(Jt, cv) of one pass whose trajectory is shipped (``mode`` 'ship':
    Zl, Ul, Fv), held ('hold': every stage at (zeta, u_prev), F and J
    formed once) or rolled from the plan ('roll': Ul through F from
    zeta) -- ``_nmpc_stage_kernel``'s three sources (qp_ipm.py:1617-1640)."""
    Np = qp.Np
    if mode == "hold":
        J = stage_jacobian(qp, zeta, up)
        cv = defects(eval_F(qp, zeta, up), J, zeta, up)
        return J.expand((Np,) + J.shape), cv.expand((Np,) + cv.shape)
    if mode == "roll":
        Z = rollout(qp, zeta, Ul)
        Zl, Fv = Z[:-1], Z[1:]
    elif mode != "ship":
        raise ValueError(f"roll mode {mode!r} not in {STAGE_MODES}")
    return stage_lin(qp, Zl, Ul, Fv=Fv)


def stage_pass(qp: NmpcQP, mode: str, zeta, up, sqRef, x0, q0, lam0_row,
               iters: int, slack_floor: float, Zl=None, Ul=None, Fv=None):
    """One SQP pass with the stage Jacobians and defects formed from its
    trajectory (``stage_linearization``), then ``jacobian_pass``; the
    plain version of csrc/nmpc_stage.cu.  Returns (x, s, lam, obj)."""
    Jt, cv = stage_linearization(qp, mode, zeta, up, Zl, Ul, Fv)
    return jacobian_pass(qp, Jt, cv, zeta, up, sqRef, x0, q0, lam0_row,
                         iters, slack_floor)


def multipass_plain(qp: NmpcQP, zeta, up, sqRef, passes: int, hold0: bool,
                    iters: int):
    """All SQP passes for lanes-minor zeta (nz, B), u_prev (m, B) and
    sqRef (p,) or (p, B): pass 0 starts from the held plan Gup u_prev
    (about the held state when ``hold0``), each later pass linearizes along
    the rollout of the previous pass's moves; every pass solves its QP
    from the previous x with cold duals, the Levenberg term q0c * x_prev
    and the slack floor 1e-2.  Returns the last pass's (x, s, lam, obj)."""
    m = qp.m
    xp = qp.Gup @ up
    group_row = [qp.cols[k] - m for k in range(1, qp.Np)]
    for p in range(passes):
        Ul = torch.cat([up] + [xp[g:g + m] for g in group_row])
        Jt, cv = stage_linearization(
            qp, "hold" if p == 0 and hold0 else "roll", zeta, up, Ul=Ul)
        x, s, lam, obj = jacobian_pass(qp, Jt, cv, zeta, up, sqRef, xp,
                                       qp.q0c[:, None] * xp, None, iters,
                                       SLACK_FLOOR)
        xp = x
    return x, s, lam, obj


def solution(qp: NmpcQP, up, x, s, lam, obj) -> QPSolution:
    """The NMPC wrappers' epilogue (qp_ipm.py:1373-1382): the ok mask,
    non-finite x to NaN, the multipliers back to original units."""
    c = qp_constants(x.dtype)
    ok, gap = ok_mask(qp.cons, rhs(qp, up), x, s, lam, c.tol, c.gap_sane)
    finite = torch.isfinite(x).all(0)
    x = torch.where(finite, x, torch.full_like(x, float("nan")))
    return QPSolution(x=x, lam=lam * obj / qp.row[:, None], ok=ok, gap=gap)
