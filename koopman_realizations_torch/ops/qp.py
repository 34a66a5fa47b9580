"""Plain lanes-minor device functions of the bilinear MPC's QP.

Each function here is the plain PyTorch counterpart of a device function
the CUDA kernels share (``csrc/kmpc_device.cuh``), and of the Pallas code
of the JAX package (``ops/pallas/qp_ipm.py``):

- ``lift_assembly``  <- ``_lift_assembly_core``  (qp_ipm.py:727-757)
- ``factored_gram``  <- ``_factored_gram``       (:760-769)
- ``diag_obj_scale`` <- ``_diag_obj_scale``      (:686-698)
- ``form_AtDA``      <- ``_make_form_AtDA``      (:209-233)
- ``chol_lanes``     <- ``_chol_lanes``          (:143-176)
- ``chol_solve_lanes`` <- ``_chol_solve_lanes``  (:179-206)
- ``mehrotra_loop``  <- ``_mehrotra_loop``       (:236-296)
- ``ok_mask``        <- the solve epilogue (qp_ipm.py:986-995; in-kernel
  at step_fused.py:137-141)

Layout: the batch is the LAST axis -- vectors are (rows, B), matrices
(n, n, B); lane-shared constraint rows A are (mc, n).  The assembly runs in
full precision of the working dtype (the TPU kernel's bf16 hi/lo GEMMs
exist only because Mosaic cannot lower Precision.HIGH), and the poly lift
is an index gather (no one-hot selection GEMMs).  Divides are IEEE and
square roots exact, as in the JAX code.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from koopman_realizations_torch.ops.observables import poly_features


class QPConstants(NamedTuple):
    reg: float          # primal regularization of the scaled Hessian
    mu_floor: float     # freeze converged lanes below this gap/residual
    tol: float          # ok: primal residual < tol * max(|b|, 1)
    gap_sane: float     # ok: complementarity gap below this


def qp_constants(dtype) -> QPConstants:
    """The solver constants of ``ops/qp.py:_solve_qp_impl`` for a dtype
    (the f32 set is the kernels')."""
    if dtype == torch.float64:
        return QPConstants(1e-11, 1e-13, 1e-4, 1e-2)
    return QPConstants(1e-7, 1e-8, 3e-3, 5e-2)


def band_offset_of(A) -> Optional[int]:
    """d such that |A|^T |A| is nonzero only on the diagonal and the +-d
    off-diagonals (0 = diagonal only), or None if no single offset covers
    it (``ops/qp.py:34`` of the JAX package).  A is host numpy."""
    A = np.asarray(A)
    if A.ndim != 2 or A.shape[0] == 0:
        return 0
    G = (np.abs(A).T @ np.abs(A)) > 0
    i, j = np.nonzero(G)
    offs = set(np.abs(i - j).tolist()) - {0}
    if not offs:
        return 0
    if len(offs) == 1:
        return int(offs.pop())
    return None


class LiftQP(NamedTuple):
    """Lane-shared operands of the lift-fused bilinear QP.

    ``gens`` stacks the generators of W (p*n rows, row r*n+i = W[r, i]),
    CB0 (m*p rows, row j*p+r = CB0[r, j]) and v (p rows); its columns act
    on the feature vector [zeta (nz); monomials (nmono); 1], zero-padded to
    a multiple of 4 columns.  A is the row-equilibrated constraint matrix,
    cFr/F0r the right-hand side in the same units, Wd/Wo the banded A^T D A
    contraction tables (Wo unused when ``band`` is None).
    """

    gens: torch.Tensor
    tables: Tuple[Tuple[torch.Tensor, torch.Tensor], ...]
    tables_host: tuple        # the same (parent, dim) index tables as ints
    rdiag: torch.Tensor
    A: torch.Tensor
    cFr: torch.Tensor
    F0r: torch.Tensor
    row: torch.Tensor
    Wd: torch.Tensor
    Wo: torch.Tensor
    n: int
    mc: int
    p: int
    m: int
    nz: int
    nmono: int
    band: Optional[int]

    @property
    def nfeat(self) -> int:
        return self.nz + self.nmono


def lift_qp_operands(gens: dict, tables, RdT, F_red, cF_red, F0_red, band,
                     dtype=torch.float32, device="cpu") -> LiftQP:
    """Device operands from the controller's f64 host constants.

    ``gens``: the z-section-folded generators Gz/Gm/Gb, Hz/Hm/Hb, Pz/Pm/Pb
    (``kmpc.py:877-897``); ``tables``: ``poly_parent_tables`` pairs.
    """
    F_red = np.asarray(F_red, np.float64)
    mc, n = F_red.shape
    p = np.asarray(gens["Pz"]).shape[0]
    m = np.asarray(gens["Hz"]).shape[0] // p
    nz = np.asarray(gens["Gz"]).shape[1]
    nmono = np.asarray(gens["Gm"]).shape[1]
    nc = nz + nmono + 1
    ncp = -(-nc // 4) * 4
    blocks = []
    for key in ("G", "H", "P"):
        z, mo, b = (np.asarray(gens[key + s], np.float64)
                    for s in ("z", "m", "b"))
        blk = np.zeros((z.shape[0], ncp))
        blk[:, :nz], blk[:, nz:nz + nmono], blk[:, nz + nmono] = z, mo, b
        blocks.append(blk)
    row = np.maximum(np.max(np.abs(F_red), axis=1), 1e-10)
    A_eq = F_red / row[:, None]
    if band is None:
        Wd = np.zeros((n, mc))
        Wo = np.zeros((1, mc))
    else:
        Wd = (A_eq * A_eq).T
        Wo = (A_eq[:, :n - band] * A_eq[:, band:]).T if band > 0 \
            else np.zeros((1, mc))
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                                  device=device)
    idx = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.long,
                                    device=device)
    return LiftQP(
        gens=t(np.concatenate(blocks)),
        tables=tuple((idx(pi), idx(di)) for pi, di in tables),
        tables_host=tuple((tuple(int(v) for v in pi),
                           tuple(int(v) for v in di)) for pi, di in tables),
        rdiag=t(RdT), A=t(A_eq), cFr=t(np.asarray(cF_red) / row),
        F0r=t(np.asarray(F0_red) / row[:, None]), row=t(row),
        Wd=t(Wd), Wo=t(Wo), n=n, mc=mc, p=p, m=m, nz=nz, nmono=nmono,
        band=band)


# ----------------------------------------------------------- assembly


def lift_features(zeta: torch.Tensor, tables) -> torch.Tensor:
    """[zeta; degree-blocked monomials] (nz + nmono, B)."""
    return torch.cat([zeta, poly_features(zeta, tables)])


def lift_assembly(qp: LiftQP, zeta, up, sqYr):
    """Poly lift + factored QP assembly for lanes-minor zeta (nz, B) and
    u_prev (m, B); ``sqYr`` is sqrt(Q)-scaled reference, (p,) shared or
    (p, B) per lane.  Returns (Wf (p*n, B), v (p, B), b (mc, B))."""
    p, n, m, nf = qp.p, qp.n, qp.m, qp.nfeat
    f = lift_features(zeta, qp.tables)
    g = qp.gens
    pn, mp = p * n, m * p
    gen = lambda rows: g[rows, :nf] @ f + g[rows, nf:nf + 1]
    Wf = gen(slice(0, pn))
    CB0 = gen(slice(pn, pn + mp))
    sq = sqYr if sqYr.ndim == 2 else sqYr[:, None]
    v = gen(slice(pn + mp, pn + mp + p)) - sq
    for j in range(m):
        v = v + CB0[j * p:(j + 1) * p] * up[j]
    b = qp.cFr[:, None].expand(qp.mc, zeta.shape[1])
    for j in range(m):
        b = b - qp.F0r[:, j:j + 1] * up[j]
    return Wf, v, b


def factored_gram(Wf, v, rdiag, p: int, n: int):
    """P = 2 (W^T W + diag(r)) (n, n, B) and qv = 2 W^T v (n, B)."""
    W = Wf.reshape(p, n, -1)
    P = torch.einsum("rib,rjb->ijb", W, W) \
        + torch.diag(rdiag)[..., None]
    qv = torch.einsum("rib,rb->ib", W, v)
    return 2.0 * P, 2.0 * qv


def diag_obj_scale(P):
    """Per-lane objective scale max |P| = max diag(P) for the PSD Gram."""
    return torch.clamp(torch.diagonal(P).amax(dim=-1), min=1e-8)


# --------------------------------------------------------- interior point


def form_AtDA(qp: LiftQP, D):
    """A^T diag(D) A (n, n, B) for D (mc, B): banded from the Wd/Wo tables
    (``band`` = the off-diagonal offset), or dense."""
    n, band = qp.n, qp.band
    if band is None:
        return torch.einsum("ci,cj,cb->ijb", qp.A, qp.A, D)
    M = _diag_lanes(qp.Wd @ D)
    if band > 0:
        og = qp.Wo @ D                                   # (n - band, B)
        i = torch.arange(n - band, device=D.device)
        M[i, i + band] += og
        M[i + band, i] += og
    return M


def _diag_lanes(d):
    """(n, B) -> (n, n, B) with d on the diagonal."""
    n = d.shape[0]
    M = d.new_zeros((n, n) + tuple(d.shape[1:]))
    i = torch.arange(n, device=d.device)
    M[i, i] = d
    return M


def chol_lanes(M):
    """Lower Cholesky factor of lanes-minor SPD blocks M (n, n, B); full
    width per column as the JAX kernel (exact sqrt, one IEEE reciprocal
    per column)."""
    n = M.shape[0]
    cols = []
    for j in range(n):
        rd = 1.0 / torch.sqrt(M[j, j])
        col = M[:, j] * rd
        cols.append(col)
        M = M - col[:, None] * col[None, :]
    L = torch.stack(cols, dim=1)
    return L * torch.tril(torch.ones(n, n, dtype=L.dtype,
                                     device=L.device))[..., None]


def chol_solve_lanes(L, rhs):
    """Solve L L^T x = rhs for rhs (n, B), column-oriented as the kernel."""
    n = L.shape[0]
    acc = rhs
    ys = []
    for k in range(n):
        yk = acc[k] / L[k, k]
        ys.append(yk)
        if k + 1 < n:
            acc = acc - L[:, k] * yk
    acc = torch.stack(ys)
    xs = [None] * n
    for i in reversed(range(n)):
        xi = acc[i] / L[i, i]
        xs[i] = xi
        if i > 0:
            acc = acc - L[i] * xi
    return torch.stack(xs)


def _max_step(v, dv):
    ratio = torch.where(dv < 0, -v / dv, torch.full_like(v, float("inf")))
    return torch.clamp(0.99 * ratio.amin(dim=0), max=1.0)


def mehrotra_loop(qp: LiftQP, iters: int, slack_floor: float, Pr, q, b,
                  x0, lam0, mu_floor: float):
    """Fixed-iteration Mehrotra predictor-corrector (``_mehrotra_loop``):
    Pr (n, n, B) regularized scaled Hessian, q (n, B), b (mc, B), starts
    x0 (n, B) and lam0 (mc, B).  Returns (x, s, lam)."""
    A = qp.A
    At = A.T
    mc = qp.mc
    x, lam = x0, lam0
    s = torch.clamp(b - A @ x0, min=slack_floor)
    for _ in range(iters):
        mu = (s * lam).sum(0) / mc
        r_p = A @ x + s - b
        r_d = torch.einsum("ijb,jb->ib", Pr, x) + q + At @ lam
        active = (mu > mu_floor) | (r_p.abs().amax(0) > mu_floor)
        D = torch.clamp(lam / s, 1e-14, 1e14)
        L = chol_lanes(Pr + form_AtDA(qp, D))

        def direction(r_slam):
            rhs = -r_d - At @ ((-r_slam + lam * r_p) / s)
            dx = chol_solve_lanes(L, rhs)
            ds = -r_p - A @ dx
            dlam = (-r_slam - lam * ds) / s
            return dx, ds, dlam

        dx_a, ds_a, dlam_a = direction(s * lam)
        alpha_a = torch.minimum(_max_step(s, ds_a), _max_step(lam, dlam_a))
        mu_aff = ((s + alpha_a * ds_a) * (lam + alpha_a * dlam_a)).sum(0) \
            / mc
        sigma = (mu_aff / (mu + 1e-30)) ** 3
        dx, ds, dlam = direction(s * lam + ds_a * dlam_a - sigma * mu)
        alpha = torch.where(active, torch.minimum(_max_step(s, ds),
                                                  _max_step(lam, dlam)),
                            torch.zeros_like(mu))
        step = lambda v, dv: torch.where(torch.isfinite(dv), v + alpha * dv,
                                         v)
        x, s, lam = step(x, dx), step(s, ds), step(lam, dlam)
    return x, s, lam


def ok_mask(qp: LiftQP, b, x, s, lam, tol: float, gap_sane: float):
    """Lane survives when its iterate is finite, the gap is sane and the
    primal residual is within ``tol`` of the row scale.  Returns (ok, gap)
    as (B,) tensors."""
    gap = (s * lam).sum(0) / qp.mc
    r_p = torch.clamp(qp.A @ x - b, min=0.0).amax(0)
    bmax = torch.clamp(b.abs().amax(0), min=1.0)
    ok = torch.isfinite(x).all(0) & (gap < gap_sane) & (r_p < tol * bmax)
    return ok, gap


def qp_core_plain(qp: LiftQP, zeta, up, sqYr, x0, lam0_row, iters: int,
                  slack_floor: float):
    """Lift + assembly + Gram + obj scale + Mehrotra for lanes-minor
    inputs -- the plain version of the QP half of both kernels.

    ``lam0_row``: dual start in row-equilibrated * obj units (mc, B), or
    None for the cold start lam = 1.  Returns (x, s, lam, obj, b).
    """
    c = qp_constants(zeta.dtype)
    Wf, v, b = lift_assembly(qp, zeta, up, sqYr)
    P, qv = factored_gram(Wf, v, qp.rdiag, qp.p, qp.n)
    obj = diag_obj_scale(P)
    iobj = 1.0 / obj
    eye = torch.eye(qp.n, dtype=P.dtype, device=P.device)[..., None]
    Pr = P * iobj + c.reg * eye
    q = qv * iobj
    if lam0_row is None:
        lam0 = torch.ones_like(b)
    else:
        lam0 = torch.sqrt(torch.clamp(lam0_row * iobj, 1e-4, 1e4))
    x, s, lam = mehrotra_loop(qp, iters, slack_floor, Pr, q, b, x0, lam0,
                              c.mu_floor)
    return x, s, lam, obj, b
