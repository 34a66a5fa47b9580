"""The port's integrators (``ops/integrators.py``) and unrolled solvers
(``ops/batch_linalg.py``) against the JAX package's on the same inputs,
f64.

- ``rk4``, ``sdirk2`` in each ``jac_mode`` and ``rk45`` on the harmonic
  oscillator of ``tests/test_arm.py:125``: against JAX within 1e-12
  (measured <= 5e-16; rk45 at ode45's and at tight tolerances) and
  against the exact solution at that test's bounds.
- ``rk45`` lanes-minor on oscillators of different frequencies (their
  step counts differ): each lane within 1e-12 of JAX ``vmap``, and
  bitwise the lane integrated alone -- a lane that has finished does not
  move while the others go on, nor does its step size.
- ``batch_linalg`` at n = 3, 6, 12, 27 and batched: within 1e-12 of JAX
  (relative to the solution's size; measured <= 3e-15).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from koopman_realizations_tpu.ops import batch_linalg as JL
from koopman_realizations_tpu.ops import integrators as JI

from koopman_realizations_torch.ops import batch_linalg as TL
from koopman_realizations_torch.ops import integrators as TI

from test_torch_oracle import one_thread  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("one_thread")

TRUTH = np.array([np.cos(1.0), -np.sin(1.0)])


def _osc_t(x):
    return torch.stack([x[1], -x[0]])


def _osc_j(x):
    return jnp.stack([x[1], -x[0]])


X0 = np.array([1.0, 0.0])


def test_rk4_matches_jax():
    got = TI.rk4(_osc_t, torch.from_numpy(X0), 1.0, 100).numpy()
    ref = np.asarray(JI.rk4(_osc_j, jnp.asarray(X0), 1.0, 100))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12)
    np.testing.assert_allclose(got, TRUTH, rtol=0, atol=1e-8)


@pytest.mark.parametrize("jac_mode", ["substep", "step", "stage"])
@pytest.mark.parametrize("newton", [1, 4])
def test_sdirk2_matches_jax(jac_mode, newton):
    """Every Jacobian mode, one lane (x (n,)) and lanes-minor (n, B)."""
    got = TI.sdirk2(_osc_t, torch.from_numpy(X0), 1.0, 200,
                    newton_iters=newton, jac_mode=jac_mode).numpy()
    ref = np.asarray(JI.sdirk2(_osc_j, jnp.asarray(X0), 1.0, 200,
                               newton_iters=newton, jac_mode=jac_mode))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12)
    if newton == 4:
        np.testing.assert_allclose(got, TRUTH, rtol=0, atol=1e-4)
    X = np.stack([X0, [0.3, -0.7], [-1.0, 0.5]], axis=1)
    lanes = TI.sdirk2(_osc_t, torch.from_numpy(X), 1.0, 20,
                      newton_iters=newton, jac_mode=jac_mode).numpy()
    vm = np.asarray(jax.vmap(lambda x: JI.sdirk2(
        _osc_j, x, 1.0, 20, newton_iters=newton, jac_mode=jac_mode))(
            jnp.asarray(X.T)))
    np.testing.assert_allclose(lanes, vm.T, rtol=0, atol=1e-12)


@pytest.mark.parametrize("tols", [dict(), dict(rtol=1e-9, atol=1e-12)])
def test_rk45_matches_jax(tols):
    got = TI.rk45(_osc_t, torch.from_numpy(X0), 1.0, **tols).numpy()
    ref = np.asarray(JI.rk45(_osc_j, jnp.asarray(X0), 1.0, **tols))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12)
    if tols:
        np.testing.assert_allclose(got, TRUTH, rtol=0, atol=1e-7)


def test_rk45_lanes_finish_apart():
    """Oscillators of frequencies 0.5-12 rad/s take different step
    counts; each lane is JAX's vmap'd lane and bitwise the lane alone, so
    a finished lane holds its state and step size."""
    w = np.array([0.5, 2.0, 6.0, 12.0])
    X = np.stack([np.ones(4), np.zeros(4)])
    wt = torch.from_numpy(w)
    f = lambda x: torch.stack([x[1], -(wt ** 2) * x[0]])
    state = TI.rk45_start(torch.from_numpy(X), 1.0)
    counts = []
    while bool(TI.rk45_active(state, 1.0, 1000).any()):
        state = TI.rk45_iteration(f, state, 1.0)
        counts.append(state[3].clone())
    steps = state[3].numpy()
    assert len(set(steps.tolist())) > 1, steps
    for b in range(4):
        wb = torch.from_numpy(w[b:b + 1])
        alone = TI.rk45(lambda x: torch.stack([x[1], -(wb ** 2) * x[0]]),
                        torch.from_numpy(X[:, b:b + 1]), 1.0)
        assert torch.equal(alone[:, 0], state[1][:, b])
        ref = np.asarray(JI.rk45(
            lambda x: jnp.stack([x[1], -(w[b] ** 2) * x[0]]),
            jnp.asarray(X[:, b]), 1.0))
        np.testing.assert_allclose(state[1][:, b].numpy(), ref, rtol=0,
                                   atol=1e-12)
    # once a lane stops counting, its t, x and h stay as they were
    assert (state[0].numpy() >= 1.0 - 1e-12).all()
    more = TI.rk45_iteration(f, state, 1.0)
    for a, b in zip(state, more):
        assert torch.equal(a, b)


def _spd(rng, n, batch=()):
    G = rng.standard_normal(batch + (n, n))
    return G @ np.swapaxes(G, -1, -2) + n * np.eye(n)


@pytest.mark.parametrize("n", [3, 6, 12, 27])
def test_batch_linalg_matches_jax(n):
    rng = np.random.default_rng(n)
    M = _spd(rng, n, (5,))
    b = rng.standard_normal((5, n))
    A = rng.standard_normal((5, n, n)) + 3 * np.eye(n)
    L = TL.chol_unrolled(torch.from_numpy(M)).numpy()
    np.testing.assert_allclose(L, np.asarray(jax.vmap(JL.chol_unrolled)(
        jnp.asarray(M))), rtol=0, atol=1e-12 * np.abs(L).max())
    assert np.array_equal(np.triu(L, 1), np.zeros_like(L))
    for name in ("solve_spd_unrolled", "solve_via_normal_unrolled"):
        mat = M if name == "solve_spd_unrolled" else A
        x = getattr(TL, name)(torch.from_numpy(mat),
                              torch.from_numpy(b)).numpy()
        ref = np.asarray(jax.vmap(getattr(JL, name))(jnp.asarray(mat),
                                                     jnp.asarray(b)))
        np.testing.assert_allclose(x, ref, rtol=0,
                                   atol=1e-12 * np.abs(ref).max())
    x = TL.chol_solve_unrolled(torch.from_numpy(L[0]),
                               torch.from_numpy(b[0])).numpy()
    np.testing.assert_allclose(x, np.linalg.solve(M[0], b[0]), rtol=0,
                               atol=1e-12 * np.abs(x).max())
