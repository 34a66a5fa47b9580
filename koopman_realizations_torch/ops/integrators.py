"""ODE integrators of plant simulation (port of ``ops/integrators.py`` of
the JAX package): fixed-step RK4, the L-stable SDIRK2 with Newton stages
and the adaptive Dormand-Prince ``rk45``.

Lanes-minor: the state is x (n,) or (n, *lanes), one column a lane, and
``f`` maps it to dx/dt of the same shape, lane by lane.  Each function
integrates every lane at once, as ``jax.vmap`` of the JAX function would;
``rk45`` keeps each lane's time, step size, step count and accept
decision, and a lane that has reached T holds its state and step size
while the others go on.  Jacobians are forward-mode (``torch.func.jvp``,
one tangent per state component under ``torch.func.vmap``); the small
solves are ``ops/batch_linalg.py``'s unrolled Cholesky.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

import torch

from koopman_realizations_torch.ops.batch_linalg import (
    chol_solve_unrolled,
    chol_unrolled,
    solve_via_normal_unrolled,
)

__all__ = ["rk4_step", "rk4", "jacobian", "sdirk2", "rk45", "rk45_start",
           "rk45_iteration", "rk45_active", "DP_A", "DP_B5", "DP_B4"]


def rk4_step(f, x, dt: float):
    """One classical Runge-Kutta step of dx/dt = f(x)."""
    k1 = f(x)
    k2 = f(x + 0.5 * dt * k1)
    k3 = f(x + 0.5 * dt * k2)
    k4 = f(x + dt * k3)
    return x + (dt / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)


def rk4(f, x0, T: float, substeps: int):
    """Integrate dx/dt = f(x) over [0, T] with ``substeps`` RK4 steps."""
    dt = T / substeps
    x = x0
    for _ in range(substeps):
        x = rk4_step(f, x, dt)
    return x


def jacobian(f, x: torch.Tensor) -> torch.Tensor:
    """J (n, n, *lanes) with J[r, c] = d f_r / d x_c of each lane, by
    forward mode: one ``jvp`` per unit tangent, the n under ``vmap``."""
    n = x.shape[0]
    eye = torch.eye(n, dtype=x.dtype, device=x.device)
    basis = eye.reshape((n, n) + (1,) * (x.ndim - 1)).expand((n,) + x.shape)
    cols = torch.func.vmap(
        lambda t: torch.func.jvp(f, (x,), (t,))[1])(basis)
    return cols.transpose(0, 1)


def _lanes(A: torch.Tensor) -> torch.Tensor:
    """(n, n, *lanes) -> (*lanes, n, n), the batch_linalg layout."""
    return A.movedim((0, 1), (-2, -1))


def sdirk2(f, x0: torch.Tensor, T: float, substeps: int,
           newton_iters: int = 3, jac_mode: str = "substep",
           jac: Optional[Callable] = None) -> torch.Tensor:
    """L-stable 2-stage SDIRK (gamma = 1 - 1/sqrt(2)) with Newton stages
    over [0, T] in ``substeps`` steps (JAX ``integrators.py:37-148``).

    ``jac_mode`` 'substep': modified Newton, the iteration matrix
    M = I - gamma dt J built at each substep's entry state and factored
    through its normal equations once for both stages and every Newton
    iteration; 'step': one factorization for the whole interval, at x0;
    'stage': exact Newton, J fresh at every iteration, each system solved
    through its normal equations.  ``jac(x)`` gives J (n, n, *lanes)
    (default ``jacobian``)."""
    jac = (lambda x: jacobian(f, x)) if jac is None else jac
    gamma = 1.0 - 1.0 / torch.sqrt(
        torch.full((), 2.0, dtype=x0.dtype, device=x0.device))
    dt = T / substeps
    gdt = gamma * dt
    omg = 1.0 - gamma
    n = x0.shape[0]
    eye = torch.eye(n, dtype=x0.dtype, device=x0.device).reshape(
        (n, n) + (1,) * (x0.ndim - 1))

    def rows(v):                        # (n, *lanes) -> (*lanes, n)
        return v.movedim(0, -1)

    def cols(v):
        return v.movedim(-1, 0)

    if jac_mode in ("step", "substep"):
        def factor(x):
            M = _lanes(eye - gdt * jac(x))
            Mt = M.transpose(-1, -2)
            return Mt, chol_unrolled(Mt @ M)

        def substep(x, Mt, L):
            def solve(r):
                return cols(chol_solve_unrolled(
                    L, (Mt @ rows(r)[..., None])[..., 0]))

            def stage(x_base, k):
                for _ in range(newton_iters):
                    fx = f(x_base + gdt * k)
                    k = k - solve(k - fx)
                return k

            k1 = stage(x, f(x))
            k2 = stage(x + omg * dt * k1, k1)
            return x + dt * (omg * k1 + gamma * k2)

        x = x0
        if jac_mode == "step":
            Mt0, L0 = factor(x0)
        for _ in range(substeps):
            Mt, L = (Mt0, L0) if jac_mode == "step" else factor(x)
            x = substep(x, Mt, L)
        return x
    if jac_mode != "stage":
        raise ValueError(f"unknown jac_mode {jac_mode!r}")

    def stage_exact(x_base, k):
        for _ in range(newton_iters):
            xs = x_base + gdt * k
            fx = f(xs)
            A = _lanes(eye - gdt * jac(xs))
            k = k - cols(solve_via_normal_unrolled(A, rows(k - fx)))
        return k

    x = x0
    for _ in range(substeps):
        k1 = stage_exact(x, f(x))
        k2 = stage_exact(x + omg * dt * k1, k1)
        x = x + dt * (omg * k1 + gamma * k2)
    return x


# Dormand-Prince 5(4) coefficients (the pair of MATLAB's ode45)
DP_A = [
    [],
    [1 / 5],
    [3 / 40, 9 / 40],
    [44 / 45, -56 / 15, 32 / 9],
    [19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729],
    [9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656],
    [35 / 384, 0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84],
]
DP_B5 = (35 / 384, 0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0)
DP_B4 = (5179 / 57600, 0, 7571 / 16695, 393 / 640, -92097 / 339200,
         187 / 2100, 1 / 40)


@functools.lru_cache(maxsize=None)
def _dp_weights(dtype, device) -> tuple:
    """(b5, b4) as tensors, made once per dtype and device: a CUDA graph
    capture cannot copy them from the host (the capture's warm-up call
    makes them)."""
    return tuple(torch.tensor(b, dtype=dtype, device=device)
                 for b in (DP_B5, DP_B4))


def _dp_step(f, x, h):
    """One Dormand-Prince step of size h (a lane's own, shape (*lanes,)):
    the 5th-order state and each lane's max |x5 - x4|."""
    ks = []
    for row in DP_A:
        xi = x
        for a, k in zip(row, ks):
            xi = xi + h * a * k
        ks.append(f(xi))
    K = torch.stack(ks)
    b5, b4 = _dp_weights(x.dtype, x.device)
    x5 = x + h * torch.tensordot(b5, K, dims=1)
    x4 = x + h * torch.tensordot(b4, K, dims=1)
    return x5, (x5 - x4).abs().amax(0)


def rk45_start(x0: torch.Tensor, T: float) -> tuple:
    """The start of ``rk45``: (t, x, h, i), each lane at t = 0 with the
    first step h0 = T / 50 and no steps taken."""
    t = torch.zeros(x0.shape[1:], dtype=x0.dtype, device=x0.device)
    return (t, x0, torch.full_like(t, T / 50.0),
            torch.zeros(x0.shape[1:], dtype=torch.int32, device=x0.device))


def rk45_active(state, T: float, max_steps: int) -> torch.Tensor:
    """The lanes still integrating: t < T and fewer than ``max_steps``
    iterations."""
    t, _, _, i = state
    return (t < T) & (i < max_steps)


def rk45_iteration(f, state, T: float, rtol: float = 1e-3,
                   atol: float = 1e-6, max_steps: int = 1000) -> tuple:
    """One iteration of the step controller (JAX ``integrators.py:181-193``)
    in every active lane: a step of h = min(h, T - t), accepted where
    its error is within atol + rtol max|x| of the lane, and the next h
    from the error ratio with safety factor 0.9, within [0.2, 5] times
    the last and [1e-10, T].  An inactive lane keeps t, x, h and its
    count exactly."""
    t, x, h, i = state
    active = rk45_active(state, T, max_steps)
    h = torch.minimum(h, T - t)
    x_new, err = _dp_step(f, x, h)
    tol = atol + rtol * x.abs().amax(0)
    accept = active & (err <= tol)
    t_new = torch.where(accept, t + h, t)
    x_new = torch.where(accept, x_new, x)
    ratio = torch.where(err > 0, tol / err, torch.full_like(err, 10.0))
    h_new = torch.clamp(h * torch.clamp(0.9 * ratio ** 0.2, 0.2, 5.0),
                        1e-10, T)
    return (t_new, x_new, torch.where(active, h_new, state[2]),
            i + active.to(i.dtype))


def rk45(f, x0: torch.Tensor, T: float, rtol: float = 1e-3,
         atol: float = 1e-6, max_steps: int = 1000) -> torch.Tensor:
    """Adaptive Dormand-Prince over [0, T] with ode45's tolerances by
    default (JAX ``integrators.py:151-197``): ``rk45_iteration`` until no
    lane is active (one host check an iteration)."""
    single = x0.ndim == 1
    x0 = x0[:, None] if single else x0
    state = rk45_start(x0, T)
    while bool(rk45_active(state, T, max_steps).any()):
        state = rk45_iteration(f, state, T, rtol, atol, max_steps)
    return state[1][:, 0] if single else state[1]
