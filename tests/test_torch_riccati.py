"""The port's stage-wise Riccati solvers (``ops/riccati.py``) against the
JAX package's and against the condensed QP, on ``tests/test_riccati.py``'s
problems, f64.

- ``solve_lq_stagewise`` and ``solve_lq_box_barrier`` against JAX within
  1e-10 (measured <= 4e-15), at Np = 12 and Np = 200, one problem and a
  leading problem axis (each problem against JAX's own);
- against the condensed QP: the unconstrained optimum within 1e-8 of the
  dense solve, the boxed one within 5e-3 of the interior point on the
  stacked box (the bounds of ``tests/test_riccati.py``), bounds active;
- a problem with a non-finite cost gives ok False and NaN, the others of
  the batch are untouched.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from koopman_realizations_tpu.ops import riccati as JR
from koopman_realizations_tpu.ops.qp import solve_qp

from koopman_realizations_torch.ops import riccati as TR

from test_riccati import _condense, _problem
from test_torch_oracle import one_thread  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("one_thread")


def _np(seed, Np=12):
    return [np.array(a) for a in _problem(Np=Np, seed=seed)]


def _t(args):
    return [torch.from_numpy(a) for a in args]


@pytest.mark.parametrize("Np,seed", [(12, 0), (12, 3), (200, 7)])
def test_both_solvers_match_jax(Np, seed):
    args = _np(seed, Np)
    U, Z = TR.solve_lq_stagewise(*_t(args))
    Uj, Zj = JR.solve_lq_stagewise(*map(jnp.asarray, args))
    np.testing.assert_allclose(U.numpy(), np.asarray(Uj), rtol=0, atol=1e-10)
    np.testing.assert_allclose(Z.numpy(), np.asarray(Zj), rtol=0, atol=1e-10)
    kw = dict(outer_iters=16, newton_iters=2) if Np == 12 else {}
    Ub, ok = TR.solve_lq_box_barrier(*_t(args), -0.6, 0.6, **kw)
    Ubj, okj = JR.solve_lq_box_barrier(*map(jnp.asarray, args), -0.6, 0.6,
                                       **kw)
    assert bool(ok) and bool(okj)
    np.testing.assert_allclose(Ub.numpy(), np.asarray(Ubj), rtol=0,
                               atol=1e-10)


def test_batched_as_jax_vmap():
    """z0 of 6 problems and their own costs qs, over one shared (A, B)."""
    A, B, Qs, Rs, qs, rs, z0 = _np(1)
    rng = np.random.default_rng(2)
    z0s = rng.normal(size=(6,) + z0.shape)
    qss = qs[None] + 0.3 * rng.normal(size=(6,) + qs.shape)
    U, Z = TR.solve_lq_stagewise(*_t([A, B, Qs, Rs, qss, rs, z0s]))
    Ub, ok = TR.solve_lq_box_barrier(*_t([A, B, Qs, Rs, qss, rs, z0s]),
                                     -0.6, 0.6, mu0=2.0, mu_decay=0.5)
    assert U.shape == (6,) + rs.shape and Z.shape == (6,) + qs.shape
    assert ok.shape == (6,) and bool(ok.all())
    for p in range(6):
        one = [jnp.asarray(a) for a in (A, B, Qs, Rs, qss[p], rs, z0s[p])]
        Uj, Zj = JR.solve_lq_stagewise(*one)
        np.testing.assert_allclose(U[p].numpy(), np.asarray(Uj), rtol=0,
                                   atol=1e-10)
        np.testing.assert_allclose(Z[p].numpy(), np.asarray(Zj), rtol=0,
                                   atol=1e-10)
        Ubj, _ = JR.solve_lq_box_barrier(*one, -0.6, 0.6, mu0=2.0,
                                         mu_decay=0.5)
        np.testing.assert_allclose(Ub[p].numpy(), np.asarray(Ubj), rtol=0,
                                   atol=1e-10)


def test_against_the_condensed_qp():
    args = _np(0)
    U, Z = TR.solve_lq_stagewise(*_t(args))
    P, f = _condense(*args)
    Np = args[3].shape[0]
    np.testing.assert_allclose(U.numpy(),
                               np.linalg.solve(P, -f).reshape(Np, -1),
                               rtol=0, atol=1e-8)
    A, B = args[0], args[1]
    z = args[6]
    for k, u in enumerate(U.numpy()):
        np.testing.assert_allclose(Z.numpy()[k], z, rtol=0, atol=1e-10)
        z = A @ z + B @ u

    args = _np(3)
    Ub, ok = TR.solve_lq_box_barrier(*_t(args), -0.6, 0.6, outer_iters=16,
                                     newton_iters=2)
    Ub = Ub.numpy()
    assert bool(ok) and Ub.min() >= -0.6 - 1e-9 and Ub.max() <= 0.6 + 1e-9
    assert (np.abs(np.abs(Ub) - 0.6) < 1e-2).any()
    P, f = _condense(*args)
    nU = Ub.size
    Abox = np.concatenate([np.eye(nU), -np.eye(nU)], axis=0)
    sol = solve_qp(jnp.asarray(P), jnp.asarray(f), jnp.asarray(Abox),
                   jnp.asarray(np.full(2 * nU, 0.6)), iters=30)
    assert bool(sol.ok)
    np.testing.assert_allclose(Ub, np.asarray(sol.x).reshape(Ub.shape),
                               rtol=0, atol=5e-3)


def test_non_finite_problem_is_flagged():
    A, B, Qs, Rs, qs, rs, z0 = _np(0)
    qss = np.stack([qs, qs])
    qss[1, 3, 0] = np.nan
    Ub, ok = TR.solve_lq_box_barrier(*_t([A, B, Qs, Rs, qss, rs, z0]),
                                     -0.6, 0.6)
    assert ok.tolist() == [True, False]
    assert torch.isnan(Ub[1]).all() and torch.isfinite(Ub[0]).all()
    one, ok0 = TR.solve_lq_box_barrier(*_t([A, B, Qs, Rs, qs, rs, z0]),
                                       -0.6, 0.6)
    assert bool(ok0) and torch.equal(one, Ub[0])
