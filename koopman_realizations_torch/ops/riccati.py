"""Stage-wise (Riccati) solvers of long-horizon LQ tracking (port of
``ops/riccati.py`` of the JAX package).

The condensed QP of the controllers has a dense (m Np)^2 Hessian, cubic
in the horizon.  These solvers keep the block-tridiagonal structure: a
backward Riccati recursion and a forward rollout solve

    min  sum_{k=0}^{Np} 1/2 z_k' Qk z_k + qk' z_k
       + sum_{k=0}^{Np-1} 1/2 u_k' Rk u_k + rk' u_k
    s.t. z_{k+1} = A z_k + B u_k,  z0 fixed

in O(Np (n+m)^3).  ``solve_lq_box_barrier`` adds input boxes by a
log-barrier path whose Newton steps are LQ problems of the same form (the
barrier only changes Rk and rk).

Batched over a leading problem axis, as ``jax.vmap`` of the JAX
functions: each argument has its unbatched shape, or one more leading
axis of P problems (any subset may carry it; the others are shared).  The
small SPD solves are ``ops/batch_linalg.py``'s unrolled Cholesky; the
stages run as a Python loop of batched matrix products on the operands'
device.
"""

from __future__ import annotations

import math

import torch

from koopman_realizations_torch.ops.batch_linalg import (
    chol_solve_unrolled,
    chol_unrolled,
)

__all__ = ["solve_lq_stagewise", "solve_lq_box_barrier"]


def _solve_spd(M, X):
    """M^-1 X for SPD M (..., m, m); X (..., m) or (..., m, k), whose
    columns are solved together."""
    L = chol_unrolled(M)
    if X.ndim == M.ndim - 1:
        return chol_solve_unrolled(L, X)
    return chol_solve_unrolled(L[..., None, :, :],
                               X.transpose(-1, -2)).transpose(-1, -2)


def _mv(M, v):
    return (M @ v[..., None])[..., 0]


def _batch(args: dict, ndims: dict) -> tuple:
    """The arguments as tensors with a leading problem axis (size 1 where
    shared) and whether any carried one."""
    out, batched = {}, False
    like = next(a for a in args.values() if torch.is_tensor(a))
    for k, a in args.items():
        a = torch.as_tensor(a, dtype=like.dtype, device=like.device)
        if a.ndim == ndims[k] + 1:
            batched = True
        elif a.ndim == ndims[k]:
            a = a[None]
        else:
            raise ValueError(f"{k}: {a.ndim} dimensions, expected "
                             f"{ndims[k]} or {ndims[k] + 1}")
        out[k] = a
    return out, batched


_NDIMS = dict(A=2, B=2, Qs=3, Rs=3, qs=2, rs=2, z0=1)


def _stagewise(A, B, Qs, Rs, qs, rs, z0):
    """``solve_lq_stagewise`` on operands that all carry the leading
    problem axis."""
    Np = Rs.shape[-3]
    At, Bt = A.transpose(-1, -2), B.transpose(-1, -2)
    V, v = Qs[:, -1], qs[:, -1]
    Ks, ds = [None] * Np, [None] * Np
    for k in reversed(range(Np)):
        VB = V @ B
        Guu = Rs[:, k] + Bt @ VB
        Gux = VB.transpose(-1, -2) @ A                       # (m, n)
        gu = rs[:, k] + _mv(Bt, v)
        K = -_solve_spd(Guu, Gux)
        d = -_solve_spd(Guu, gu)
        Guxt = Gux.transpose(-1, -2)
        V1 = Qs[:, k] + At @ V @ A + Guxt @ K
        v = qs[:, k] + _mv(At, v) + _mv(Guxt, d)
        # symmetrized: roundoff asymmetry compounds over long horizons
        V = 0.5 * (V1 + V1.transpose(-1, -2))
        Ks[k], ds[k] = K, d
    z = z0
    U, Z = [], []
    for k in range(Np):
        u = _mv(Ks[k], z) + ds[k]
        U.append(u)
        Z.append(z)
        z = _mv(A, z) + _mv(B, u)
    Z.append(z)
    return torch.stack(U, 1), torch.stack(Z, 1)


def solve_lq_stagewise(A, B, Qs, Rs, qs, rs, z0):
    """Backward Riccati and forward rollout of the LQ tracking problem.

    A (n, n), B (n, m) time-invariant dynamics; Qs (Np+1, n, n) /
    qs (Np+1, n) state costs; Rs (Np, m, m) / rs (Np, m) input costs;
    z0 (n,); each may lead with a problem axis P.  Returns (U [Np, m],
    Z [Np+1, n]), each with the problem axis where an operand had it."""
    ops, batched = _batch(dict(A=A, B=B, Qs=Qs, Rs=Rs, qs=qs, rs=rs, z0=z0),
                          _NDIMS)
    U, Z = _stagewise(**ops)
    return (U, Z) if batched else (U[0], Z[0])


def solve_lq_box_barrier(A, B, Qs, Rs, qs, rs, z0, u_lo, u_hi,
                         outer_iters: int = 12, newton_iters: int = 1,
                         mu0: float = 1.0, mu_decay: float = 0.4):
    """LQ tracking with u_lo <= u_k <= u_hi by a log-barrier Riccati path
    (JAX ``riccati.py:105-151``): from the box's middle, ``outer_iters``
    barrier weights mu0 mu_decay^i, each with ``newton_iters`` Newton
    steps; a step is the LQ problem in du about the feasible rollout with
    the barrier's diagonal Hessian and gradient added to (Rk, rk), taken
    to 0.995 of the distance to the box's boundary (at most a full step).

    Operands as ``solve_lq_stagewise``'s; u_lo, u_hi scalars or (m,).
    Returns (U [Np, m], ok): ok False where a non-finite value appeared,
    and that problem's U is NaN."""
    ops, batched = _batch(dict(A=A, B=B, Qs=Qs, Rs=Rs, qs=qs, rs=rs, z0=z0),
                          _NDIMS)
    A, B, Qs, Rs, qs, rs, z0 = (ops[k] for k in _NDIMS)
    P = max(t.shape[0] for t in ops.values())
    Np, m = Rs.shape[-3], Rs.shape[-1]
    like = dict(dtype=Rs.dtype, device=Rs.device)
    u_lo = torch.as_tensor(u_lo, **like).expand(m)
    u_hi = torch.as_tensor(u_hi, **like).expand(m)
    U = (0.5 * (u_lo + u_hi)).expand(P, Np, m)    # strictly interior start

    def rollout(U):
        z = z0.expand(P, z0.shape[-1])
        Z = [z]
        for k in range(Np):
            z = _mv(A, z) + _mv(B, U[:, k])
            Z.append(z)
        return torch.stack(Z, 1)

    def newton_step(U, mu):
        Z = rollout(U)
        slo, shi = U - u_lo, u_hi - U                 # strictly positive
        Rbar = Rs + torch.diag_embed(mu * (1.0 / slo ** 2 + 1.0 / shi ** 2))
        gu = _mv(Rs, U) + rs - mu * (1.0 / slo - 1.0 / shi)
        gz = _mv(Qs, Z) + qs
        dU, _ = _stagewise(A, B, Qs, Rbar, gz, gu, torch.zeros_like(Z[:, 0]))
        inf = torch.full_like(dU, math.inf)
        ratio = torch.where(dU < 0, -slo / dU,
                            torch.where(dU > 0, shi / dU, inf))
        alpha = torch.clamp(0.995 * ratio.amin((1, 2)), max=1.0)
        return U + alpha[:, None, None] * dU

    for i in range(outer_iters):
        mu = mu0 * mu_decay ** i
        for _ in range(newton_iters):
            U = newton_step(U, mu)
    ok = torch.isfinite(U).all(2).all(1)
    U = torch.where(ok[:, None, None], U, torch.full_like(U, math.nan))
    return (U, ok) if batched else (U[0], ok[0])
