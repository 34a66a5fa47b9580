"""L1-constrained Koopman regression (port of ``ops/lasso.py:24-169`` of
the JAX package; the reference's LASSO QP, ``Ksysid.solve_KoopmanQP``).

    min ||Px K - Py||_F^2   s.t.  ||vec(K)||_1 <= t
    (+ delay constraints pinning shift-structure entries of K)

solved as projected accelerated gradient (FISTA) on the matrix variable:
the gradient 2 (G K - H) with G = Px^T Px, H = Px^T Py, the step 1 / L
with L = 2 lambda_max(G) from 30 power iterations, and Duchi's L1-ball
projection (sort and prefix sum).  Everything runs on the caller's device
and batches over leading axes (one system, one ball, per leading index);
no iteration reads a value back to the host except the ``tol`` check,
once every 100 iterations.

- ``lasso_constrained_lstsq``: a fixed number of iterations in the
  caller's dtype (the JAX ``lasso_constrained_lstsq``; the random-system
  sweep runs it over its system axis).
- ``lasso_fista_f64``: the trainer's route (the JAX host mirror
  ``lasso_constrained_lstsq_f64``), the same algorithm step for step in
  f64 on the device, stopped by ``tol`` on the Gram-form objective.

The JAX package's certification oracles (``lasso_oracle_*``) are test
tools; the port keeps no copy.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from koopman_realizations_torch.utils.timing import DeviceClock


def _ball_projector(n: int, dtype, device):
    """``project_l1_ball`` for rows of length n, its index tables made
    once (FISTA projects every iteration)."""
    k = torch.arange(1, n + 1, dtype=dtype, device=device)
    idx = torch.arange(n, device=device)
    none = torch.full_like(idx, -1)

    def proj(v, t):
        abs_v = v.abs()
        inside = abs_v.sum(-1) <= t
        u = torch.sort(abs_v, dim=-1, descending=True).values
        css = torch.cumsum(u, dim=-1)
        rho = torch.where(u * k > css - t[..., None], idx, none).amax(-1)
        css_rho = torch.gather(css, -1, (rho % n)[..., None])[..., 0]
        theta = (css_rho - t) / (rho + 1).to(dtype)
        proj = torch.sign(v) * torch.clamp(abs_v - theta[..., None], min=0.0)
        return torch.where(inside[..., None], v, proj)
    return proj


def project_l1_ball(v: torch.Tensor, t) -> torch.Tensor:
    """Euclidean projection of each row of v (..., n) onto
    {x : ||x||_1 <= t} (Duchi et al.), t a number or a tensor of v's
    leading shape.  A row already inside its ball comes back unchanged;
    a budget t <= 0 follows the JAX formula (rho = -1 indexes the last
    prefix sum, theta = inf: the projection is 0)."""
    t = torch.as_tensor(t, dtype=v.dtype, device=v.device)
    return _ball_projector(v.shape[-1], v.dtype, v.device)(v, t)


class FistaResult(NamedTuple):
    """A FISTA run: K (..., Nm, Nm), and per leading index (numbers for
    one system, numpy arrays of the leading shape for a batch) the
    iterations run, the final objective ||Px K - Py||^2 in Gram form and
    the milliseconds from the start to its stop (CUDA events on a CUDA
    device); objective and ms only with ``tol``."""

    K: torch.Tensor
    iters: Any
    objective: Any = None
    ms: Any = None


def _momentum(iters: int, dtype) -> np.ndarray:
    """FISTA's momentum factors (t_k - 1) / t_{k+1}, t_0 = 1, in ``dtype``
    (the scan carry of the JAX version)."""
    npdt = np.float64 if dtype == torch.float64 else np.float32
    tk, out = npdt(1.0), np.empty(iters, npdt)
    for i in range(iters):
        t_new = npdt(0.5) * (npdt(1.0) + np.sqrt(npdt(1.0)
                                                 + npdt(4.0) * tk * tk))
        out[i] = (tk - npdt(1.0)) / t_new
        tk = t_new
    return out


def _fista(G, H, t, pin_mask, pin_value: float, iters: int,
           tol: Optional[float] = None, const=None) -> FistaResult:
    """FISTA on min <K, G K> - 2 <K, H> over the (pinned) L1 ball of each
    leading index: H (..., Nm, Nm), G (Nm, Nm) or of H's shape, t a
    number or a tensor of the leading shape.  ``tol``: every 100
    iterations the objectives (+ ``const``) are read back, and each
    leading index stops (its K kept) once its change is at most
    tol * max(|f|, 1); the run ends when all have stopped."""
    nm = G.shape[-1]
    dt, dev = G.dtype, G.device
    v = torch.full(G.shape[:-1], 1.0 / float(np.sqrt(nm)), dtype=dt,
                   device=dev)
    for _ in range(30):
        v = (G @ v[..., None])[..., 0]
        v = v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    L = 2.0 * torch.clamp((v * (G @ v[..., None])[..., 0]).sum(-1),
                          min=1e-12)
    L = L[..., None, None]
    shape = H.shape
    lead = shape[:-2]
    ball = _ball_projector(nm * shape[-1], dt, dev)
    # the budgets as device tensors once: a Python number would be copied
    # to the card in every projection, a host sync each iteration
    t = torch.as_tensor(t, dtype=dt, device=dev)
    if pin_mask is not None:
        pin = torch.as_tensor(pin_mask, dtype=torch.bool, device=dev)
        budget = t - pin_value * pin.sum().to(dt)

        def proj(K):
            free = torch.where(pin, torch.zeros_like(K), K)
            free = ball(free.reshape(lead + (-1,)), budget).reshape(shape)
            return torch.where(pin, torch.full_like(K, pin_value), free)
    else:
        def proj(K):
            return ball(K.reshape(lead + (-1,)), t).reshape(shape)

    def objective(K) -> np.ndarray:
        f = (K * (G @ K)).sum((-2, -1)) - 2.0 * (K * H).sum((-2, -1))
        return f.cpu().numpy().reshape(-1) + const

    K = proj(torch.zeros_like(H))
    Z = K
    if tol is not None:
        clock = DeviceClock(dev)
        start = clock.mark()
        rows = int(np.prod(lead, dtype=np.int64))
        f_prev = objective(K)
        done = np.zeros(rows, bool)
        run, f_out = np.full(rows, iters), np.empty(rows)
        marks = [None] * rows
        K_out = torch.empty_like(K).reshape((rows,) + shape[-2:])
    for it, mom in enumerate(_momentum(iters, dt)):
        grad = 2.0 * (G @ Z - H)
        K_new = proj(Z - grad / L)
        Z = K_new + float(mom) * (K_new - K)
        K = K_new
        if tol is None or (it + 1) % 100:
            continue
        f = objective(K)
        stop = ~done & (np.abs(f_prev - f)
                        <= tol * np.maximum(np.abs(f), 1.0))
        if stop.any():
            sel = torch.as_tensor(np.flatnonzero(stop), device=dev)
            K_out[sel] = K.reshape(K_out.shape)[sel]
            run[stop], f_out[stop] = it + 1, f[stop]
            mark = clock.mark()
            marks = [mark if st else mk for st, mk in zip(stop, marks)]
            done |= stop
            if done.all():
                break
        f_prev = f
    if tol is None:
        return FistaResult(K=K, iters=iters)
    if not done.all():
        rest = ~done
        sel = torch.as_tensor(np.flatnonzero(rest), device=dev)
        K_out[sel] = K.reshape(K_out.shape)[sel]
        f_out[rest] = objective(K)[rest]
        mark = clock.mark()
        marks = [mark if r else mk for r, mk in zip(rest, marks)]
    ms = np.asarray([clock.ms(start, mk) for mk in marks])
    out = lambda a: a.reshape(lead) if lead else a[0].item()
    return FistaResult(K=K_out.reshape(shape), iters=out(run),
                       objective=out(f_out), ms=out(ms))


def lasso_constrained_lstsq(Px: torch.Tensor, Py: torch.Tensor, t,
                            pin_mask=None, pin_value: float = 1.0,
                            iters: int = 2000) -> torch.Tensor:
    """FISTA for min ||Px K - Py||_F^2 s.t. ||vec(K)||_1 <= t, ``iters``
    iterations in Px's dtype on its device (the JAX
    ``lasso_constrained_lstsq``).  Px (..., K, Nm) and Py (..., K, Nm)
    batch over leading axes, t a number or a tensor of their leading
    shape; ``pin_mask`` (Nm, Nm) bool, entries held at ``pin_value``
    (the reference's delay constraints, ``Ksysid.m:1139-1164``), whose
    absolute values consume L1 budget."""
    G = Px.mT @ Px
    H = Px.mT @ Py
    return _fista(G, H, t, pin_mask, pin_value, iters).K


def lasso_fista_f64(Px: torch.Tensor, Py: torch.Tensor, t,
                    pin_mask=None, pin_value: float = 1.0,
                    iters: int = 2000,
                    tol: Optional[float] = None) -> FistaResult:
    """The trainer's LASSO route (the JAX host mirror
    ``lasso_constrained_lstsq_f64``): the same FISTA in f64 on Px's device,
    capped at ``iters``; with ``tol`` the Gram-form objective is checked
    every 100 iterations and the loop stops once its change is at most
    tol * max(|f|, 1) (the paper-scale Gram is conditioned at ~1e17, where
    a fixed 2000 iterations leave a visible objective gap).  Returns K with
    its iteration count and, with ``tol``, its final objective
    ||Px K - Py||^2 (Gram form) and time.  t a number, or a sequence of
    budgets: one fit each on the same Px, Py, run as one batch
    (K (len(t), Nm, Nm)), each stopped by ``tol`` on its own."""
    Px = Px.to(torch.float64)
    Py = Py.to(device=Px.device, dtype=torch.float64)
    G = Px.mT @ Px
    H = Px.mT @ Py
    const = float((Py ** 2).sum().item()) if tol is not None else None
    if np.ndim(t):
        H = H.expand((len(t),) + H.shape)
        t = torch.as_tensor(np.asarray(t, np.float64), device=Px.device)
    return _fista(G, H, t, pin_mask, pin_value, iters, tol, const)
