"""Random scalar nonlinear systems (port of ``models/rsys.py`` of the JAX
package; reference class ``Rsys``).

``Rsys.construct_systems:34-91`` draws systems

    xdot = exp(-x^4) * ( sum_j coeff_j * x^px_j u^pu_j  +  c * u ) - atan(x)

with random coefficients and binary exponent selectors over the monomial
dictionary [x]*degree_x + [u]*degree_u, then simulates trials under random
piecewise-constant step inputs (``simulate_systems:96-125``,
``generate_input_steps:136-150``).

The draws are host numpy from the caller's ``np.random.Generator`` in the
JAX package's order, so one seed gives the same ensemble and inputs in
both packages, bit for bit.  The simulation is one batched RK4 over
systems x trials, a lane each, on the device.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

from koopman_realizations_torch import resolve_device
from koopman_realizations_torch.ops.integrators import rk4
from koopman_realizations_torch.types import DataSet, Trial


def ipow(x: torch.Tensor, k: int) -> torch.Tensor:
    """x ** k for a Python integer k >= 0 by binary exponentiation, the
    products of JAX's ``integer_pow`` in its order (x ** 0 = 1)."""
    if k == 0:
        return torch.ones_like(x)
    acc = None
    while k > 0:
        if k & 1:
            acc = x if acc is None else acc * x
        k >>= 1
        if k > 0:
            x = x * x
    return acc


@dataclasses.dataclass(frozen=True)
class RsysEnsemble:
    """Parameters of num_sys random systems (stacked leading axis), host
    numpy f64."""

    coeffs: np.ndarray      # (S, num_terms)
    px: np.ndarray          # (S, num_terms) powers of x per term
    pu: np.ndarray          # (S, num_terms) powers of u per term
    cu: np.ndarray          # (S,) isolated input gain (2*(2 rand - 1))

    @property
    def num_sys(self) -> int:
        return self.coeffs.shape[0]

    def lanes(self, s_idx, dtype=torch.float64, device="cuda") -> tuple:
        """(coeffs, px, pu, cu) of the systems ``s_idx`` (one per lane) as
        tensors: (L, num_terms) x 3 and (L,)."""
        s_idx = np.asarray(s_idx)
        dev = resolve_device(device)
        return tuple(torch.as_tensor(np.asarray(a)[s_idx], dtype=dtype,
                                     device=dev)
                     for a in (self.coeffs, self.px, self.pu, self.cu))

    @staticmethod
    def vf_lanes(params: tuple, x: torch.Tensor, u: torch.Tensor):
        """xdot of every lane: ``params`` from ``lanes``, x and u (L,)."""
        coeffs, px, pu, cu = params
        terms = coeffs * torch.pow(x[:, None], px) * torch.pow(u[:, None],
                                                               pu)
        return torch.exp(-ipow(x, 4)) * (terms.sum(-1) + cu * u) \
            - torch.atan(x)

    def vf(self, s_idx: int, x, u, device="cuda"):
        """xdot of system ``s_idx`` at scalar (or (L,)) x and u."""
        x = torch.as_tensor(x, dtype=torch.float64,
                            device=resolve_device(device)).reshape(-1)
        u = torch.as_tensor(u, dtype=x.dtype, device=x.device).reshape(-1)
        params = self.lanes(np.full(x.shape[0], s_idx), x.dtype, x.device)
        return self.vf_lanes(params, x, u)


def construct_systems(num_sys: int, num_terms: int, degree_x: int,
                      degree_u: int, rng: np.random.Generator) -> RsysEnsemble:
    """Draw the ensemble (``Rsys.construct_systems``): each term
    multiplies a random subset of the dictionary [x]*degree_x +
    [u]*degree_u, i.e. x^px u^pu with px ~ Binomial(degree_x),
    pu ~ Binomial(degree_u); selectors are iid fair coin flips."""
    coeffs = 2.0 * rng.random((num_sys, num_terms)) - 1.0
    sel_x = rng.integers(0, 2, (num_sys, num_terms, degree_x))
    sel_u = rng.integers(0, 2, (num_sys, num_terms, degree_u))
    px = sel_x.sum(axis=2)
    pu = sel_u.sum(axis=2)
    cu = 2.0 * (2.0 * rng.random(num_sys) - 1.0)
    return RsysEnsemble(coeffs=coeffs.astype(float), px=px.astype(float),
                        pu=pu.astype(float), cu=cu.astype(float))


def generate_input_steps(rng: np.random.Generator, T: int,
                         num_steps: int = 50) -> np.ndarray:
    """Piecewise-constant random inputs in [-1, 1] held for num_steps
    samples (``Rsys.generate_input_steps``; the trailing partial block
    stays 0)."""
    u = np.zeros(T)
    ind = np.arange(0, T, num_steps)
    vals = 2.0 * rng.random(len(ind)) - 1.0
    for i in range(len(ind) - 1):
        u[ind[i]: ind[i + 1]] = vals[i]
    return u


def simulate_lanes(ens: RsysEnsemble, U: np.ndarray, Ts: float,
                   x0: float = 0.0, substeps: int = 8,
                   dtype=torch.float64, device="cuda") -> torch.Tensor:
    """The states (S, R, T) of every system under every input trial of U
    (S, R, T), one RK4 lane per (system, trial), on the device: x_0 = x0,
    then ``substeps`` RK4 steps a sample period, the input held."""
    S, R, T = U.shape
    dev = resolve_device(device)
    params = ens.lanes(np.repeat(np.arange(S), R), dtype, dev)
    u_all = torch.as_tensor(U.reshape(S * R, T), dtype=dtype, device=dev)
    X = torch.empty((S * R, T), dtype=dtype, device=dev)
    x = torch.full((S * R,), float(x0), dtype=dtype, device=dev)
    X[:, 0] = x
    for k in range(T - 1):
        u = u_all[:, k]
        x = rk4(lambda xx: RsysEnsemble.vf_lanes(params, xx, u), x, Ts,
                substeps)
        X[:, k + 1] = x
    return X.reshape(S, R, T)


def simulate_systems(ens: RsysEnsemble, t_end: float, Ts: float,
                     num_trials: int, rng: np.random.Generator,
                     x0: float = 0.0, substeps: int = 8,
                     device="cuda") -> List[DataSet]:
    """Simulate num_trials step-input trials per system in one batch
    (``simulate_lanes``, f64) and return one DataSet per system with the
    last trial held out for validation (``Rsys.save_data:198-203``)."""
    t = np.arange(0.0, t_end + 1e-12, Ts)
    T = len(t)
    S = ens.num_sys
    U = np.stack([[generate_input_steps(rng, T) for _ in range(num_trials)]
                  for _ in range(S)])                      # (S, R, T)
    X = simulate_lanes(ens, U, Ts, x0, substeps,
                       device=device).cpu().numpy()
    datasets = []
    for s in range(S):
        trials = [Trial(t=t, y=X[s, r][:, None], u=U[s, r][:, None])
                  for r in range(num_trials)]
        datasets.append(DataSet(train=trials[:-1], val=trials[-1:]))
    return datasets
