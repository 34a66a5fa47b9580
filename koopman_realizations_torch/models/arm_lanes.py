"""Lane-structured arm plant step (port of ``models/arm_lanes.py``).

Every scalar state component is its own ``(B,)`` tensor (struct of
arrays), the layout of one lanes-minor row.  ``rhs_soa`` is the closed-form
planar-chain Euler-Lagrange right-hand side and ``sdirk2_rows`` the
modified-Newton SDIRK2 over one control period, both as in the JAX file.

The stage Jacobian, which the JAX code takes from n forward-mode
``jax.jvp`` basis passes, comes here from ONE pass of forward-mode dual
numbers through the same ``rhs_soa``: each component carries its value
(B,) and its n tangents (n, B), seeded with the unit basis, so the output
tangents are the Jacobian's columns.  The CUDA step kernel
(``csrc/kmpc_device.cuh``) does the same with a dual-number struct.

``rhs_lanes`` is the same closed form on stacked tensors, the state
(nx, B) at once: each term is one operation over all links (a, ad as
(N, B), the pairwise angles as (N, N, B)), about half of
``rhs_soa``'s launches a call.  The integrators that evaluate the RHS
hundreds of times a control period (RK4, Dormand-Prince, SDIRK2 with
exact Newton, ``models/arm.py``) take it: a replayed period of 'rk4' or
'rk45' runs in 0.52-0.60 of the time it takes on ``rhs_soa`` (an H100,
f32, B=65536; ``chip_smoke.py --measure plant-rhs``).  Exact Newton's
Jacobian comes from ``rhs_soa``'s dual numbers (``jacobian_rows``),
which the host dispatches faster than ``torch.func`` forward mode
through ``rhs_lanes``.
"""

from __future__ import annotations

import torch

from koopman_realizations_torch.ops.batch_linalg import (
    chol_soa,
    chol_solve_soa,
)

__all__ = ["Dual", "rhs_soa", "rhs_lanes", "LaneTables", "LaneLoads",
           "sdirk2_rows"]


class Dual:
    """Forward-mode dual number: value v (B,) and tangents d (k, B)."""

    __slots__ = ("v", "d")

    def __init__(self, v, d):
        self.v = v
        self.d = d

    def __add__(self, o):
        if isinstance(o, Dual):
            return Dual(self.v + o.v, self.d + o.d)
        return Dual(self.v + o, self.d)

    __radd__ = __add__

    def __sub__(self, o):
        if isinstance(o, Dual):
            return Dual(self.v - o.v, self.d - o.d)
        return Dual(self.v - o, self.d)

    def __rsub__(self, o):
        return Dual(o - self.v, -self.d)

    def __neg__(self):
        return Dual(-self.v, -self.d)

    def __mul__(self, o):
        if isinstance(o, Dual):
            return Dual(self.v * o.v, self.d * o.v + self.v * o.d)
        return Dual(self.v * o, self.d * o)

    __rmul__ = __mul__

    # quotient rules in jax's jvp form: dx / y + (-dy * x) * y^-2
    def __truediv__(self, o):
        if isinstance(o, Dual):
            return Dual(self.v / o.v,
                        self.d / o.v + (-o.d * self.v) * (1.0 / (o.v * o.v)))
        return Dual(self.v / o, self.d / o)

    def __rtruediv__(self, o):
        return Dual(o / self.v, (-self.d * o) * (1.0 / (self.v * self.v)))

    def sqrt(self):
        r = torch.sqrt(self.v)
        return Dual(r, self.d * (0.5 / r))


def _sin(x):
    if isinstance(x, Dual):
        return Dual(torch.sin(x.v), x.d * torch.cos(x.v))
    return torch.sin(x)


def _cos(x):
    if isinstance(x, Dual):
        return Dual(torch.cos(x.v), -(x.d * torch.sin(x.v)))
    return torch.cos(x)


# ------------------------------------------------------------------ dynamics


def rhs_soa(cfg, G, bvec, a, ad, u, w1, w2):
    """Joint accelerations; a, ad: length-N lists of (B,) components (or
    ``Dual``s); u: length-Nmods list; w1/w2: (B,) load mass and gravity
    tilt; G, bvec: the host inertia/lever tables of ``Arm``."""
    N = cfg.Nlinks
    l2 = cfg.l ** 2
    i_rot = cfg.i

    th, thd = [], []
    run_a = None
    run_d = None
    for i in range(N):
        run_a = a[i] if run_a is None else run_a + a[i]
        run_d = ad[i] if run_d is None else run_d + ad[i]
        th.append(run_a)
        thd.append(run_d)

    cos_pq = [[None] * N for _ in range(N)]
    sin_pq = [[None] * N for _ in range(N)]
    for p in range(N):
        for q in range(p):
            dth = th[p] - th[q]
            cos_pq[p][q] = cos_pq[q][p] = _cos(dth)
            s = _sin(dth)
            sin_pq[p][q] = s
            sin_pq[q][p] = -s

    def cf(p, q):
        return l2 * (cfg.m * float(G[p][q])) + l2 * w1

    M_th = [[None] * N for _ in range(N)]
    for p in range(N):
        M_th[p][p] = cf(p, p) + i_rot
        for q in range(p):
            M_th[p][q] = M_th[q][p] = cf(p, q) * cos_pq[p][q]

    T1 = [[None] * N for _ in range(N)]         # T1[p][j] = sum_{q>=j} M_th
    for p in range(N):
        run = None
        for j in reversed(range(N)):
            run = M_th[p][j] if run is None else run + M_th[p][j]
            T1[p][j] = run
    Dq = [[None] * N for _ in range(N)]         # Dq[i][j] = sum_{p>=i} T1
    for j in range(N):
        run = None
        for i in reversed(range(N)):
            run = T1[i][j] if run is None else run + T1[i][j]
            Dq[i][j] = run

    thd2 = [t * t for t in thd]
    s_row = []
    for p in range(N):
        acc = None
        for q in range(N):
            if q == p:
                continue
            term = cf(p, q) * sin_pq[p][q] * thd2[q]
            acc = term if acc is None else acc + term
        s_row.append(acc if acc is not None else 0.0 * th[0])
    C = [None] * N
    run = None
    for k in reversed(range(N)):
        run = s_row[k] if run is None else run + s_row[k]
        C[k] = run

    grav = []
    for j in range(N):
        lever = cfg.m * float(bvec[j]) + w1
        grav.append(lever * _sin(th[j] - w2))
    dPE = [None] * N
    run = None
    for k in reversed(range(N)):
        run = grav[k] if run is None else run + grav[k]
        dPE[k] = cfg.g * cfg.l * run + cfg.k * a[k]

    rhs = []
    for k in range(N):
        tau_k = -cfg.ku * (u[k // cfg.nlinks] - a[k])
        non_inert = C[k] + dPE[k] + cfg.d * ad[k] + tau_k
        rhs.append(-non_inert)

    L = chol_soa(Dq, N)
    return chol_solve_soa(L, rhs, N)


class LaneTables:
    """``rhs_lanes``' constant tables in one dtype on one device: the
    inertia coefficients l^2 m G (N, N, 1), the rotor inertia on the
    diagonal i I (N, N, 1) and the gravity levers m b (N, 1)."""

    def __init__(self, cfg, G, bvec, dtype, device):
        N = cfg.Nlinks
        t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
        self.cfm = t(cfg.l ** 2 * (cfg.m * G))[..., None]
        self.irot = (cfg.i * torch.eye(N, dtype=dtype, device=device))[
            ..., None]
        self.lev = t(cfg.m * bvec)[:, None]


class LaneLoads:
    """The terms of ``rhs_lanes`` that a control period holds fixed (the
    inputs u (Nmods, B) and loads w1, w2 (B,)), made once a period: the
    inertia coefficients cf = l^2 (m G + w1) (N, N, B), the gravity levers
    m b + w1 (N, B), ku u on each link (N, B) and the tilt w2."""

    def __init__(self, cfg, tables: LaneTables, u, w1, w2):
        self.cf = tables.cfm + cfg.l ** 2 * w1
        self.lever = tables.lev + w1
        ur = u if cfg.nlinks == 1 else u.repeat_interleave(cfg.nlinks, 0)
        self.kur = cfg.ku * ur
        self.w2 = w2
        self.irot = tables.irot


def rhs_lanes(cfg, loads: LaneLoads, x):
    """dx/dt of every lane: x (nx, B) = [a; ad] under the period's
    ``loads``; ``rhs_soa``'s closed form on stacked tensors, returns
    [ad; addot] (nx, B).  The suffix sums of the mass matrix run over both
    axes reversed at once (Dq[i][j] is R[N-1-i][N-1-j]); the Coriolis and
    gravity rows share one suffix sum, and the spring and input torques
    one (k + ku) a term."""
    N = cfg.Nlinks
    a, ad = x[:N], x[N:]
    thb = torch.cumsum(x.reshape(2, N, -1), 1)           # th, thd
    th, thd = thb[0], thb[1]
    dth = th[:, None] - th[None]                        # th_p - th_q
    cf = loads.cf
    R = (cf * torch.cos(dth) + loads.irot).flip((0, 1)).cumsum(0).cumsum(1)
    s_row = (cf * torch.sin(dth) * (thd * thd)[None]).sum(1)
    grav = loads.lever * torch.sin(th - loads.w2)
    gen = (s_row + cfg.g * cfg.l * grav).flip(0).cumsum(0).flip(0)
    rhs = -(gen + (cfg.k + cfg.ku) * a + cfg.d * ad - loads.kur)
    L = chol_soa([[R[N - 1 - i, N - 1 - j] for j in range(N)]
                  for i in range(N)], N)
    addot = chol_solve_soa(L, [rhs[i] for i in range(N)], N)
    return torch.cat([ad, torch.stack(addot)])


def make_rhs_tuple(cfg, G, bvec, us, w1, w2):
    """RHS over the state tuple xs = (a_0..a_{N-1}, ad_0..ad_{N-1})."""
    N = cfg.Nlinks

    def f(*xs):
        a = list(xs[:N])
        ad = list(xs[N:])
        addot = rhs_soa(cfg, G, bvec, a, ad, us, w1, w2)
        return tuple(ad) + tuple(addot)

    return f


def jacobian_rows(f, xs):
    """J[r][c] = d f_r / d x_c at xs, as (B,) entries, from one dual pass."""
    n = len(xs)
    eye = torch.eye(n, dtype=xs[0].dtype, device=xs[0].device)
    duals = tuple(Dual(xs[c], eye[c][:, None].expand(n, xs[c].shape[0]))
                  for c in range(n))
    out = f(*duals)
    return [[out[r].d[c] for c in range(n)] for r in range(n)]


# ---------------------------------------------------------------- integrator


def sdirk2_rows(cfg, G, bvec, xs0, us, w1, w2, Ts, substeps, newton_iters,
                jac_mode):
    """SDIRK2 over one control period on tuples of (B,) rows.

    gamma = 1 - 1/sqrt(2); modified Newton with a normal-equation
    factorization of the iteration matrix, refreshed once per period
    (jac_mode 'step') or per substep ('substep') -- ``sdirk2_rows`` of the
    JAX package, line for line.
    """
    n = 2 * cfg.Nlinks
    # gamma in the component dtype, as the JAX code pins it (a fill, not
    # a host copy, so that the period can be captured in a CUDA graph)
    gamma = 1.0 - 1.0 / torch.sqrt(
        torch.full((), 2.0, dtype=xs0[0].dtype, device=xs0[0].device))
    dt = Ts / substeps

    f = make_rhs_tuple(cfg, G, bvec, list(us), w1, w2)

    def factor(xs):
        J = jacobian_rows(f, xs)
        M = [[(1.0 if r == c else 0.0) - gamma * dt * J[r][c]
              for c in range(n)] for r in range(n)]
        Nm = [[None] * n for _ in range(n)]
        for r in range(n):
            for c in range(r + 1):
                s = None
                for k in range(n):
                    t = M[k][r] * M[k][c]
                    s = t if s is None else s + t
                Nm[r][c] = Nm[c][r] = s
        return M, chol_soa(Nm, n)

    def solve_normal(M, L, r):
        Mtr = []
        for i in range(n):
            s = None
            for k in range(n):
                t = M[k][i] * r[k]
                s = t if s is None else s + t
            Mtr.append(s)
        return chol_solve_soa(L, Mtr, n)

    def substep(xs, M, L):
        def stage(x_base, k):
            for _ in range(newton_iters):
                xk = tuple(x_base[i] + gamma * dt * k[i] for i in range(n))
                fx = f(*xk)
                res = [k[i] - fx[i] for i in range(n)]
                delta = solve_normal(M, L, res)
                k = tuple(k[i] - delta[i] for i in range(n))
            return k

        k1 = stage(xs, f(*xs))
        k2 = stage(tuple(xs[i] + (1.0 - gamma) * dt * k1[i]
                         for i in range(n)), k1)
        return tuple(xs[i] + dt * ((1.0 - gamma) * k1[i] + gamma * k2[i])
                     for i in range(n))

    xs = tuple(xs0)
    if jac_mode == "step":
        M0, L0 = factor(xs)
        for _ in range(substeps):
            xs = substep(xs, M0, L0)
    elif jac_mode == "substep":
        for _ in range(substeps):
            M, L = factor(xs)
            xs = substep(xs, M, L)
    else:
        raise NotImplementedError(f"jac_mode {jac_mode!r} is not ported")
    return xs
