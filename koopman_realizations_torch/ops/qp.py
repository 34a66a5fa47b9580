"""Plain lanes-minor device functions of the MPC QPs.

Each function here is the plain PyTorch counterpart of a device function
the CUDA kernels share (``csrc/kmpc_device.cuh``), and of the Pallas code
of the JAX package (``ops/pallas/qp_ipm.py``):

- ``lift_assembly``  <- ``_lift_assembly_core``  (qp_ipm.py:727-757)
- ``bilin_assemble`` <- ``_bilin_assemble``      (ops/qp.py:272-282; in
  ``_bilin_kernel``, qp_ipm.py:1036-1047)
- ``factored_gram``  <- ``_factored_gram``       (:760-769)
- ``factored_core``  <- the factored mode of ``_ipm_kernel`` (:340-367,
  :385-399): Gram, objective scale, dual start, Mehrotra
- ``diag_obj_scale`` <- ``_diag_obj_scale``      (:686-698)
- ``form_AtDA``      <- ``_make_form_AtDA``      (:209-233)
- ``chol_lanes``     <- ``_chol_lanes``          (:143-176)
- ``chol_solve_lanes`` <- ``_chol_solve_lanes``  (:179-206)
- ``mehrotra_loop``  <- ``_mehrotra_loop``       (:236-296), its
  iterations ``mehrotra_iterations`` on any layout
- ``ok_mask``        <- the solve epilogue (qp_ipm.py:986-995; in-kernel
  at step_fused.py:137-141)
- ``solve_qp``       <- ``solve_qp(..., shared_A=True)`` under vmap
  (ops/qp.py:85-157, 1204-1252): the shared-A entry, routed to the
  lane-shared or per-lane Hessian mode of ``ops/kernels/ipm_shared.py``
- ``solve_qp_lane_A`` <- ``solve_qp(..., shared_A=False)`` under vmap
  (ops/qp.py:1255-1379, ``_solve_qp_impl``): a Hessian AND constraint
  rows per lane, the bilinear controller's state-bound QPs
  (``bilinear_solve_pure``, control/kmpc.py:679-687).  The JAX package
  runs this route outside Pallas (``_solve_qp`` routes only shared A to
  a kernel), so no TPU kernel computes it and it stays plain PyTorch on
  the device (ROADMAP.md, perf queue: a per-lane-A kernel)

The interior point takes its lane-shared constraint rows as a
``Constraints`` (row-equilibrated A and its banded or dense A^T D A
tables), which every controller's QP shares; its Hessian is per lane
(n, n, B) or lane-shared (n, n).

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


class QPSolution(NamedTuple):
    """A batched solve's result, lanes-minor (the JAX ``QPSolution``)."""

    x: torch.Tensor      # (n, B) primal solution, NaN where not finite
    lam: torch.Tensor    # (mc, B) multipliers in original units
    ok: torch.Tensor     # (B,) bool
    gap: torch.Tensor    # (B,) final complementarity gap


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


class Constraints(NamedTuple):
    """Lane-shared constraint rows of a batched QP, row-equilibrated:
    A = F / row, with the banded A^T D A tables Wd (n, mc) and Wo
    (n - band, mc) (Wo unused when ``band`` is 0).  Dense (``band``
    None): ``cols`` holds each row's nonzero columns, ascending and
    padded with -1 (host ints, ``row_nonzeros``), Wd their values
    (mc, len(cols[0])) and Wo is unused."""

    A: torch.Tensor
    row: torch.Tensor
    Wd: torch.Tensor
    Wo: torch.Tensor
    n: int
    mc: int
    band: Optional[int]
    cols: tuple = ()


def row_nonzeros(A):
    """(cols, vals) of host rows A (mc, n): each row's nonzero columns,
    ascending, padded with -1 to the widest row, as a tuple of tuples,
    and their values (mc, width) with zeros in the padding."""
    A = np.asarray(A, np.float64)
    idx = [np.flatnonzero(a) for a in A]
    width = max([len(i) for i in idx] + [1])
    cols = tuple(tuple(int(c) for c in i) + (-1,) * (width - len(i))
                 for i in idx)
    vals = np.zeros((A.shape[0], width))
    for c, i in enumerate(idx):
        vals[c, :len(i)] = A[c, i]
    return cols, vals


def constraint_tables(F, band):
    """(row, A_eq, Wd, Wo) of host constraint rows F (mc, n), f64 numpy:
    the row scale max(|F_c|, 1e-10), the equilibrated rows and the
    A^T D A tables: banded contractions (``qp_ipm.py:464-492``) or, for
    ``band`` None, each row's nonzero values (``row_nonzeros``)."""
    F = np.asarray(F, np.float64)
    mc, n = F.shape
    row = np.maximum(np.max(np.abs(F), axis=1), 1e-10)
    A_eq = F / row[:, None]
    if band is None:
        Wd = row_nonzeros(A_eq)[1]
        Wo = np.zeros((1, mc))
    else:
        Wd = (A_eq * A_eq).T
        Wo = (A_eq[:, :n - band] * A_eq[:, band:]).T if band > 0 \
            else np.zeros((1, mc))
    return row, A_eq, Wd, Wo


class LiftQP(NamedTuple):
    """Lane-shared operands of the lift-fused bilinear QP.

    ``gens`` stacks the generators of W (p*n rows, row r*n+i = W[r, i]),
    CB0 (m*p rows, row j*p+r = CB0[r, j]) and v (p rows); its columns act
    on the feature vector [zeta (nz); monomials (nmono); 1], zero-padded to
    a multiple of 4 columns.  A is the row-equilibrated constraint matrix,
    cFr/F0r the right-hand side in the same units, Wd/Wo the banded A^T D A
    contraction tables (Wo unused when ``band`` is None).  ``live`` is
    ``generator_live`` of ``gens``: which generator rows are not all zero,
    a word a stage row.
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
    live: tuple

    @property
    def nfeat(self) -> int:
        return self.nz + self.nmono

    @property
    def cons(self) -> Constraints:
        return Constraints(self.A, self.row, self.Wd, self.Wo, self.n,
                           self.mc, self.band)


def lift_qp_operands(gens: dict, tables, RdT, F_red, cF_red, F0_red, band,
                     *, device, dtype=torch.float32) -> LiftQP:
    """Device operands from the controller's f64 host constants, on
    ``device`` (no default, so that no operand silently lands on the
    CPU).

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
    blocks = [generator_block(gens[key + "z"], gens[key + "m"],
                              gens[key + "b"], ncp)
              for key in ("G", "H", "P")]
    row, A_eq, Wd, Wo = constraint_tables(F_red, band)
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                                  device=device)
    idx = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.long,
                                    device=device)
    gens_host = torch.as_tensor(np.concatenate(blocks), dtype=dtype)
    return LiftQP(
        gens=gens_host.to(device),
        tables=tuple((idx(pi), idx(di)) for pi, di in tables),
        tables_host=tuple((tuple(int(v) for v in pi),
                           tuple(int(v) for v in di)) for pi, di in tables),
        rdiag=t(RdT), A=t(A_eq), cFr=t(np.asarray(cF_red) / row),
        F0r=t(np.asarray(F0_red) / row[:, None]), row=t(row),
        Wd=t(Wd), Wo=t(Wo), n=n, mc=mc, p=p, m=m, nz=nz, nmono=nmono,
        band=band, live=generator_live(gens_host, p, n, m))


def generator_live(gens, p: int, n: int, m: int) -> tuple:
    """Which rows of a generator stack (``LiftQP`` / ``BilinQP`` order:
    p*n W rows, m*p CB0 rows, p v rows; a host tensor in the kernels'
    dtype) are not all zero, one word a stage row r: bit i for W[r, i]
    (row r*n + i), bit n + j for CB0[r, j] (row n*p + j*p + r), bit n + m
    for v's row r (row (n + m)*p + r).  The all-zero W rows are the
    stages that no move block reaches, the CB0 rows the stages that
    u_prev does not reach (``csrc/kmpc_device.cuh:assemble`` skips them)."""
    if n + m >= 32:
        raise ValueError("generator_live: n + m must stay below 32")
    nz = (torch.as_tensor(gens).cpu() != 0).any(1).tolist()
    W, H, P = nz[:p * n], nz[p * n:p * n + m * p], nz[p * n + m * p:]
    return tuple(sum(int(W[r * n + i]) << i for i in range(n))
                 | sum(int(H[j * p + r]) << (n + j) for j in range(m))
                 | int(P[r]) << (n + m) for r in range(p))


class BilinQP(NamedTuple):
    """Lane-shared operands of the assembly-fused bilinear QP (the
    ``_bilin_kernel`` route): ``gens`` stacks PGWb (p*n rows, row r*n+i =
    W[r, i]), PG0 (m*p rows, row j*p+r = CB0[r, j]) and PAsq (p rows),
    their columns acting on the lifted state z (nzl), zero-padded to a
    multiple of 4; the rest (``live`` too) as ``LiftQP``."""

    gens: torch.Tensor
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
    nzl: int
    band: Optional[int]
    live: tuple

    @property
    def cons(self) -> Constraints:
        return Constraints(self.A, self.row, self.Wd, self.Wo, self.n,
                           self.mc, self.band)


def generator_block(z, mono, bias, ncp: int) -> np.ndarray:
    """Generator rows [z-section | monomial section | bias | 0-pad] acting
    on the feature vector [zeta; monomials; 1] (f64)."""
    z, mono, bias = (np.asarray(a, np.float64) for a in (z, mono, bias))
    nz, nmono = z.shape[1], mono.shape[1]
    blk = np.zeros((z.shape[0], ncp))
    blk[:, :nz], blk[:, nz:nz + nmono] = z, mono
    blk[:, nz + nmono] = bias.reshape(-1)
    return blk


# ----------------------------------------------------------- assembly


def lift_features(zeta: torch.Tensor, tables) -> torch.Tensor:
    """[zeta; degree-blocked monomials] (nz + nmono, B)."""
    return torch.cat([zeta, poly_features(zeta, tables)])


def lift_assembly(qp: LiftQP, zeta, up, sqYr):
    """Poly lift + factored QP assembly for lanes-minor zeta (nz, B) and
    u_prev (m, B); ``sqYr`` is sqrt(Q)-scaled reference, (p,) shared or
    (p, B) per lane.  Returns (Wf (p*n, B), v (p, B), b (mc, B))."""
    nf = qp.nfeat
    f = lift_features(zeta, qp.tables)
    g = qp.gens
    return _generated(qp, lambda rows: g[rows, :nf] @ f + g[rows, nf:nf + 1],
                      up, sqYr)


def bilin_assemble(qp: BilinQP, z, up, sqYr):
    """Factored QP assembly from the lifted state z (nzl, B) and u_prev
    (m, B) against the generators (``_bilin_assemble``); ``sqYr`` (p,) or
    (p, B).  Returns (Wf (p*n, B), v (p, B), b (mc, B))."""
    g = qp.gens
    return _generated(qp, lambda rows: g[rows, :qp.nzl] @ z, up, sqYr)


def _generated(qp, gen, up, sqYr):
    """(Wf, v, b) from the generator rows' products ``gen(rows)``:
    W = PGW f, v = Pgen f - sqYr + CB0 u_prev, b = cFr - F0r u_prev."""
    p, n, m = qp.p, qp.n, qp.m
    pn, mp = p * n, m * p
    Wf = gen(slice(0, pn))
    CB0 = gen(slice(pn, pn + mp))
    sq = sqYr if sqYr.ndim == 2 else sqYr[:, None]
    v = gen(slice(pn + mp, pn + mp + p)) - sq
    for j in range(m):
        v = v + CB0[j * p:(j + 1) * p] * up[j]
    b = qp.cFr[:, None].expand(qp.mc, up.shape[1])
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


def form_AtDA(cons: Constraints, D):
    """A^T diag(D) A (n, n, B) for D (mc, B): banded from the Wd/Wo tables
    (``band`` = the off-diagonal offset), or dense."""
    n, band = cons.n, cons.band
    if band is None:
        return torch.einsum("ci,cj,cb->ijb", cons.A, cons.A, D)
    M = _diag_lanes(cons.Wd @ D)
    if band > 0:
        og = cons.Wo @ D                                 # (n - band, B)
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


def mehrotra_iterations(iters: int, mc: int, mu_floor: float, x, s, lam,
                        q, b, Ax, Atv, Pv, factor, solve, red):
    """The fixed-iteration Mehrotra predictor-corrector
    (``_mehrotra_loop``, qp_ipm.py:236-296) on any layout: the row
    products ``Ax`` and ``Atv``, the Hessian's ``Pv``, ``factor(D)`` of
    the Newton matrix P + A^T diag(D) A and ``solve(L, rhs)`` with it, and
    ``red(v, op)`` reducing v over its rows to one value a lane that
    broadcasts against the vectors ('sum', 'amax', 'amin').  Returns
    (x, s, lam)."""
    def max_step(v, dv):
        ratio = torch.where(dv < 0, -v / dv, torch.full_like(v, float("inf")))
        return torch.clamp(0.99 * red(ratio, "amin"), max=1.0)

    for _ in range(iters):
        mu = red(s * lam, "sum") / mc
        r_p = Ax(x) + s - b
        r_d = Pv(x) + q + Atv(lam)
        active = (mu > mu_floor) | (red(r_p.abs(), "amax") > mu_floor)
        D = torch.clamp(lam / s, 1e-14, 1e14)
        L = factor(D)

        def direction(r_slam):
            rhs = -r_d - Atv((-r_slam + lam * r_p) / s)
            dx = solve(L, rhs)
            ds = -r_p - Ax(dx)
            dlam = (-r_slam - lam * ds) / s
            return dx, ds, dlam

        dx_a, ds_a, dlam_a = direction(s * lam)
        alpha_a = torch.minimum(max_step(s, ds_a), max_step(lam, dlam_a))
        mu_aff = red((s + alpha_a * ds_a) * (lam + alpha_a * dlam_a),
                     "sum") / mc
        sigma = (mu_aff / (mu + 1e-30)) ** 3
        dx, ds, dlam = direction(s * lam + ds_a * dlam_a - sigma * mu)
        alpha = torch.where(active, torch.minimum(max_step(s, ds),
                                                  max_step(lam, dlam)),
                            torch.zeros_like(mu))
        step = lambda v, dv: torch.where(torch.isfinite(dv), v + alpha * dv,
                                         v)
        x, s, lam = step(x, dx), step(s, ds), step(lam, dlam)
    return x, s, lam


def mehrotra_loop(cons: Constraints, iters: int, slack_floor: float, Pr,
                  q, b, x0, lam0, mu_floor: float):
    """Fixed-iteration Mehrotra predictor-corrector (``_mehrotra_loop``),
    lanes-minor against lane-shared rows: Pr the regularized scaled
    Hessian, per lane (n, n, B) or lane-shared (n, n); q (n, B), b (mc, B),
    starts x0 (n, B) and lam0 (mc, B).  Returns (x, s, lam)."""
    A = cons.A
    At = A.T
    if Pr.ndim == 2:
        P_shared = Pr
        Pv = lambda v: P_shared @ v
        Pr = Pr[..., None]
    else:
        Pv = lambda v: torch.einsum("ijb,jb->ib", Pr, v)
    s = torch.clamp(b - A @ x0, min=slack_floor)
    return mehrotra_iterations(
        iters, cons.mc, mu_floor, x0, s, lam0, q, b, lambda v: A @ v,
        lambda v: At @ v, Pv,
        lambda D: chol_lanes(Pr + form_AtDA(cons, D)), chol_solve_lanes,
        lambda v, op: getattr(v, op)(0))


def ok_mask(cons: Constraints, b, x, s, lam, tol: float, gap_sane: float):
    """Lane survives when its iterate is finite, the gap is sane and the
    primal residual is within ``tol`` of the row scale.  Returns (ok, gap)
    as (B,) tensors."""
    gap = (s * lam).sum(0) / cons.mc
    r_p = torch.clamp(cons.A @ x - b, min=0.0).amax(0)
    bmax = torch.clamp(b.abs().amax(0), min=1.0)
    ok = torch.isfinite(x).all(0) & (gap < gap_sane) & (r_p < tol * bmax)
    return ok, gap


def factored_core(cons: Constraints, Wf, v, rdiag, b, x0, lam0_row,
                  iters: int, slack_floor: float, q0=None):
    """Gram + obj scale + dual start + Mehrotra of the factored QP for
    lanes-minor Wf (p*n, B), v (p, B), b (mc, B) and x0 (n, B), the
    plain version of the kernels' factored tail.

    ``lam0_row``: dual start in row-equilibrated units (mc, B), damped
    here to sqrt(clip(lam0_row / obj, 1e-4, 1e4)), or None for the cold
    start lam = 1.  ``q0`` (n, B): an additive linear term in original
    units, q = 2 W^T v + q0 before the objective scale (qp_ipm.py:355-359),
    or None.  Returns (x, s, lam, obj).
    """
    c = qp_constants(v.dtype)
    P, qv = factored_gram(Wf, v, rdiag, v.shape[0], cons.n)
    if q0 is not None:
        qv = qv + q0
    obj = diag_obj_scale(P)
    iobj = 1.0 / obj
    eye = torch.eye(cons.n, dtype=P.dtype, device=P.device)[..., None]
    Pr = P * iobj + c.reg * eye
    q = qv * iobj
    if lam0_row is None:
        lam0 = torch.ones_like(b)
    else:
        lam0 = torch.sqrt(torch.clamp(lam0_row * iobj, 1e-4, 1e4))
    x, s, lam = mehrotra_loop(cons, iters, slack_floor, Pr, q, b, x0,
                              lam0, c.mu_floor)
    return x, s, lam, obj


def solve_qp(P, q, cons: Constraints, b, iters: int = 25,
             x0: Optional[torch.Tensor] = None,
             lam0: Optional[torch.Tensor] = None) -> QPSolution:
    """Batched interior-point solve of min 1/2 x'Px + q'x s.t. A x <= b
    with the constraint rows shared by every lane (``solve_qp(...,
    shared_A=True)`` of the JAX package under vmap, ``ops/qp.py:85-157``),
    lanes-minor: P (n, n) shared by every lane or (n, n, B) per lane, q
    (n, B) and b (mc, B) in original units, ``cons`` the row-equilibrated
    A, x0 (n, B) the primal start (None: zeros, cold), lam0 (mc, B)
    multipliers in original units (None: cold).  As
    ``_pallas_routed_solver`` (:1204-1252) passes ``shared_P=not Pb``, a
    2-D P takes the lane-shared mode of ``ops/kernels/ipm_shared.py`` and a
    per-lane P its per-lane mode: on the card the ``ipm_shared`` kernel's
    two builds, on the CPU their plain versions."""
    from koopman_realizations_torch.ops.kernels.ipm_shared import (
        solve_qp_shared,
    )
    return solve_qp_shared(P, q, cons, b, x0=x0, iters=iters, lam0=lam0)


def solve_qp_lane_A(P, q, A, b, iters: int = 25,
                    x0: Optional[torch.Tensor] = None,
                    lam0: Optional[torch.Tensor] = None) -> QPSolution:
    """Batched interior-point solve of min 1/2 x'Px + q'x s.t. A x <= b
    with every operand per lane (``_solve_qp_impl`` with
    ``shared_A=False`` under vmap, JAX ``ops/qp.py:1255-1379``),
    lanes-minor: P (n, n, B), q (n, B), A (mc, n, B), b (mc, B) in
    original units, x0 (n, B) the primal start (None: zeros, cold), lam0
    (mc, B) multipliers in original units (None: cold).  Each lane's
    objective scale max |P| and row scales max |A_c| equilibrate it as
    there; the Mehrotra loop is ``mehrotra_loop``'s
    (``mehrotra_iterations``) on per-lane rows, lanes-major so that every
    product is a batched matrix product, its Newton matrix factored once
    an iteration by the batched
    ``torch.linalg.cholesky_ex`` (a lane whose matrix is not positive
    definite gets a NaN factor, and so non-finite directions, as the
    column-by-column factor's square root of a negative gives).  Plain
    PyTorch on whatever device the operands live on: the JAX package's
    counterpart never reaches Pallas."""
    c = qp_constants(q.dtype)
    n, mc = q.shape[0], b.shape[0]
    obj = torch.clamp(P.abs().amax((0, 1)), min=1e-8)       # (B,)
    row = torch.clamp(A.abs().amax(1), min=1e-10).T         # (B, mc)
    # lanes-major and contiguous: the batched products' fast layout
    A = (A.permute(2, 0, 1) / row[..., None]).contiguous()  # (B, mc, n)
    b = (b.T / row).contiguous()
    Pr = (P.permute(2, 0, 1) / obj[:, None, None]
          + c.reg * torch.eye(n, dtype=q.dtype, device=q.device)).contiguous()
    q = (q.T / obj[:, None]).contiguous()
    slack_floor = 1.0 if x0 is None else 1e-2
    x = torch.zeros_like(q) if x0 is None else x0.T.contiguous()
    lam = torch.ones_like(b) if lam0 is None else torch.sqrt(
        torch.clamp(lam0.T * row / obj[:, None], 1e-4, 1e4)).contiguous()
    mv = lambda M, v: (M @ v[..., None])[..., 0]

    def factor(D):
        L, info = torch.linalg.cholesky_ex(
            Pr + (A * D[..., None]).transpose(1, 2) @ A)
        return torch.where((info == 0)[:, None, None], L,
                           torch.full_like(L, float("nan")))

    s = torch.clamp(b - mv(A, x), min=slack_floor)
    x, s, lam = mehrotra_iterations(
        iters, mc, c.mu_floor, x, s, lam, q, b, lambda v: mv(A, v),
        lambda v: (v[:, None, :] @ A)[:, 0], lambda v: mv(Pr, v), factor,
        lambda L, r: torch.cholesky_solve(r[..., None], L)[..., 0],
        lambda v, op: getattr(v, op)(1, keepdim=True))
    gap = (s * lam).sum(1) / mc
    r_p = torch.clamp(mv(A, x) - b, min=0.0).amax(1)
    bmax = torch.clamp(b.abs().amax(1), min=1.0)
    finite = torch.isfinite(x).all(1)
    ok = finite & (gap < c.gap_sane) & (r_p < c.tol * bmax)
    x = torch.where(finite[:, None], x, torch.full_like(x, float("nan")))
    return QPSolution(x=x.T, lam=(lam * obj[:, None] / row).T, ok=ok,
                      gap=gap)


def qp_core_plain(qp: LiftQP, zeta, up, sqYr, x0, lam0_row, iters: int,
                  slack_floor: float):
    """Lift + assembly + the factored tail for lanes-minor inputs -- the
    plain version of the QP half of both lift-fused kernels.  Returns
    (x, s, lam, obj, b)."""
    Wf, v, b = lift_assembly(qp, zeta, up, sqYr)
    return factored_core(qp.cons, Wf, v, qp.rdiag, b, x0, lam0_row, iters,
                         slack_floor) + (b,)
