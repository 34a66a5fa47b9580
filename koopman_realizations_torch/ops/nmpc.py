"""Plain lanes-minor math of the whole-SQP NMPC solve.

The plain PyTorch counterpart of the device functions of
``csrc/nmpc_device.cuh`` and of the JAX package's NMPC code: the composed
dynamics F (``_eval_F_rows``, ``ops/pallas/qp_ipm.py:1397``;
``_stage_roll_xla``, ``ops/qp.py:811``), the analytic stage Jacobians
(``_stage_jacs_xla``, ``ops/qp.py:849``), the defects, the sensitivity
condensation and W/v assembly (``_nmpc_condense_core``, qp_ipm.py:1082;
``_nmpc_condense_assemble``, ops/qp.py:539) and the pass loop
(``_nmpc_multipass_pure``, ops/qp.py:1119; the kernel body
qp_ipm.py:1478-1557).  Each pass ends in the port's factored Gram,
objective scale and Mehrotra loop (``ops/qp.py``).

Layout: the batch is the LAST axis, as in ``ops/qp.py``.  The dynamics are
F(x) = A1 x + A2 mono(x) + a0 with x = [zeta; u] and mono(x) the
degree-blocked monomials of degree 2..d; the Jacobian is
J(x) = A1 + unflatten(G g_low(x)) with g_low = [x; monomials of degree
2..d-1].  G is used whole: the JAX package ships it as a bf16 hi/lo pair,
which carries ~2^-16 of relative error.  The monomials are index gathers
(no one-hot selection GEMMs).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from koopman_realizations_torch.ops.observables import poly_features
from koopman_realizations_torch.ops.qp import (
    Constraints,
    constraint_tables,
    diag_obj_scale,
    factored_gram,
    mehrotra_loop,
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
                     F_red, cF_red, F0_red, band, dtype=torch.float32,
                     device="cpu") -> NmpcQP:
    """Device operands from the controller's f64 host constants: the row
    equilibration, CzS = sq * tile(Cz) and the banded A^T D A tables, as
    the JAX wrapper forms them (qp_ipm.py:1759-1776).  ``Gc`` is
    ``jacobian_generator``'s layout, ``tables`` the ``poly_parent_tables``
    pairs over nza."""
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
    """Analytic Jacobian of F at (z, u): (Jz (nz, nz, B), Ju (nz, m, B)),
    entry [o, i] = dF_o / dx_i."""
    nz, nza = qp.nz, qp.nza
    x = torch.cat([z, u])
    g = torch.cat([x, poly_features(x, qp.tables[:-1])])
    Jc = qp.G[:, :qp.nlow] @ g                          # (nza*nz, B)
    J = qp.A1.T[..., None] + Jc.reshape(nza, nz, -1)    # [i, o]
    return J[:nz].transpose(0, 1), J[nz:].transpose(0, 1)


def defects(F, Jz, Ju, zl, ul):
    """cv = F(zl, ul) - Jz zl - Ju ul: the affine term of the
    linearization at (zl, ul)."""
    return F - torch.einsum("oib,ib->ob", Jz, zl) \
        - torch.einsum("ojb,jb->ob", Ju, ul)


def condense(qp: NmpcQP, Jz, Ju, cv, zeta, up, sqRef):
    """Sensitivity condensation and W/v assembly over the horizon: stage
    lists Jz[k] (nz, nz, B), Ju[k] (nz, m, B), cv[k] (nz, B); S_0 = 0,
    s_0 = zeta; S_{k+1} = Jz_k S_k + Ju_k at stage k's columns,
    s_{k+1} = Jz_k s_k + cv_k.  Stage k's projected rows CzS_k [S_k | s_k]
    give W (its decision columns) and v (the affine part, the reference
    subtracted and the pinned u_prev folded in).  sqRef is (p,) or
    (p, B).  Returns (W (p, n, B), v (p, B))."""
    nz, m, ns, nproj = qp.nz, qp.m, qp.ns, qp.nproj
    sq = sqRef if sqRef.ndim == 2 else sqRef[:, None]
    S = zeta.new_zeros((nz, m + qp.n, zeta.shape[1]))
    s = zeta
    W_rows, v_rows = [], []
    for k in range(qp.Np + 1):
        Ck = qp.CzS[k * nproj:(k + 1) * nproj]          # (nproj, ns)
        Pk = torch.einsum("ri,icb->rcb", Ck, S[:ns])
        vk = Ck @ s[:ns] - sq[k * nproj:(k + 1) * nproj] \
            + torch.einsum("rjb,jb->rb", Pk[:, :m], up)
        W_rows.append(Pk[:, m:])
        v_rows.append(vk)
        if k < qp.Np:
            S = torch.einsum("oib,icb->ocb", Jz[k], S)
            c0 = qp.cols[k]
            S[:, c0:c0 + m] += Ju[k]
            s = torch.einsum("oib,ib->ob", Jz[k], s) + cv[k]
    return torch.cat(W_rows), torch.cat(v_rows)


def linearize(qp: NmpcQP, zeta, u_rows, hold: bool):
    """Stage Jacobians and defects of one pass: about the held state
    (every stage at (zeta, u_prev), F and J formed once) or along the
    rollout of the stage inputs ``u_rows`` from zeta."""
    if hold:
        F0 = eval_F(qp, zeta, u_rows[0])
        Jz, Ju = stage_jacobian(qp, zeta, u_rows[0])
        cv = defects(F0, Jz, Ju, zeta, u_rows[0])
        return [Jz] * qp.Np, [Ju] * qp.Np, [cv] * qp.Np
    Jzs, Jus, cvs = [], [], []
    z = zeta
    for k in range(qp.Np):
        Fk = eval_F(qp, z, u_rows[k])
        Jz, Ju = stage_jacobian(qp, z, u_rows[k])
        Jzs.append(Jz)
        Jus.append(Ju)
        cvs.append(defects(Fk, Jz, Ju, z, u_rows[k]))
        z = Fk
    return Jzs, Jus, cvs


def multipass_plain(qp: NmpcQP, zeta, up, sqRef, passes: int, hold0: bool,
                    iters: int):
    """All SQP passes for lanes-minor zeta (nz, B), u_prev (m, B) and
    sqRef (p,) or (p, B): pass 0 starts from the held plan Gup u_prev
    (about the held state when ``hold0``), each later pass linearizes along
    the rollout of the previous pass's moves; every pass solves its QP
    from the previous x with cold duals, the Levenberg term q0c * x_prev
    and the slack floor 1e-2.  Returns the last pass's (x, s, lam, obj)."""
    c = qp_constants(zeta.dtype)
    m = qp.m
    b = qp.cFr[:, None] - qp.F0r @ up
    eye = torch.eye(qp.n, dtype=zeta.dtype, device=zeta.device)[..., None]
    xp = qp.Gup @ up
    group_row = [qp.cols[k] - m for k in range(1, qp.Np)]
    for p in range(passes):
        u_rows = [up] + [xp[g:g + m] for g in group_row]
        Jz, Ju, cv = linearize(qp, zeta, u_rows, p == 0 and hold0)
        W, v = condense(qp, Jz, Ju, cv, zeta, up, sqRef)
        P, qv = factored_gram(W.reshape(-1, W.shape[-1]), v, qp.rdiag,
                              qp.p, qp.n)
        qv = qv + qp.q0c[:, None] * xp
        obj = diag_obj_scale(P)
        iobj = 1.0 / obj
        x, s, lam = mehrotra_loop(qp.cons, iters, SLACK_FLOOR,
                                  P * iobj + c.reg * eye, qv * iobj, b, xp,
                                  torch.ones_like(b), c.mu_floor)
        xp = x
    return x, s, lam, obj
