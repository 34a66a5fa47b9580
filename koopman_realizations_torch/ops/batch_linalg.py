"""Unrolled dense solvers for small matrices at large batch sizes (port of
``ops/batch_linalg.py`` of the JAX package).

``chol_soa`` and ``chol_solve_soa`` work on a matrix given entry by entry:
a list of rows of same-shaped entries, each a tensor over the batch (or
a forward-mode dual number of ``models/arm_lanes.py``, whose Jacobian pass
runs through them).  Each step is a plain elementwise operation over the
batch, with no pivoting (SPD input).  The JAX functions below take
matrices (..., n, n) and vectors (..., n), batched over the leading axes
like any torch operation, and run on these two.
"""

from __future__ import annotations

import torch

__all__ = ["chol_soa", "chol_solve_soa", "chol_unrolled",
           "chol_solve_unrolled", "solve_spd_unrolled",
           "solve_via_normal_unrolled"]


def chol_soa(M, n):
    """Cholesky of an SPD matrix given as list-of-lists of entries."""
    L = [[None] * n for _ in range(n)]
    for j in range(n):
        s = M[j][j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        d = s.sqrt()
        L[j][j] = d
        for i in range(j + 1, n):
            s = M[i][j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = s / d
    return L


def chol_solve_soa(L, rhs, n):
    """Solve L L^T x = rhs; rhs and result are lists of entries."""
    y = [None] * n
    for i in range(n):
        s = rhs[i]
        for j in range(i):
            s = s - L[i][j] * y[j]
        y[i] = s / L[i][i]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for j in range(i + 1, n):
            s = s - L[j][i] * x[j]
        x[i] = s / L[i][i]
    return x


def _entries(M: torch.Tensor) -> list:
    """M (..., n, n) as a list of rows of (...)-shaped entries (views)."""
    n = M.shape[-1]
    return [[M[..., i, j] for j in range(n)] for i in range(n)]


def chol_unrolled(M: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of SPD matrices M (..., n, n); the strict
    upper triangle is zero."""
    n = M.shape[-1]
    L = chol_soa(_entries(M), n)
    zero = torch.zeros_like(M[..., 0, 0])
    return torch.stack([torch.stack([L[i][j] if j <= i else zero
                                     for j in range(n)], -1)
                        for i in range(n)], -2)


def chol_solve_unrolled(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x with L L^T x = b, from the factor L (..., n, n); b (..., n)."""
    n = L.shape[-1]
    x = chol_solve_soa(_entries(L), [b[..., i] for i in range(n)], n)
    return torch.stack(x, -1)


def solve_spd_unrolled(M: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x = M^-1 b for SPD M through the unrolled Cholesky (the factor's
    entries go straight to the substitutions)."""
    n = M.shape[-1]
    return torch.stack(chol_solve_soa(chol_soa(_entries(M), n),
                                      [b[..., i] for i in range(n)], n), -1)


def solve_via_normal_unrolled(A: torch.Tensor,
                              b: torch.Tensor) -> torch.Tensor:
    """x = (A^T A)^-1 A^T b: a small nonsymmetric system through its SPD
    normal equations (it squares the condition number; the implicit
    integrator's well-scaled Newton systems are what it serves)."""
    At = A.transpose(-1, -2)
    return solve_spd_unrolled(At @ A, (At @ b[..., None])[..., 0])
