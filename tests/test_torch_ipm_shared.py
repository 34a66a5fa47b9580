"""``solve_qp_shared`` (the plain version of the ``ipm_shared`` kernel plus
the JAX wrapper's equilibration and epilogue) against the JAX package's
lane-shared-Hessian solves, with the linear controller's constraint rows
(box + slope under move blocking, band 3) and its 6 iterations.

Two kinds of problems, each at B=16 and at a B that no tile divides, with
a warm primal start and cold:
- seeded feasible QPs: a random SPD Hessian of the controller's scale,
  random gradients, right-hand sides b = A x_f + slack of a random
  feasible x_f (the warm start);
- the real linear QP (``LinearKmpc.solve``'s P22, fz, bz and its shifted
  plan start) at closed-loop states: the carries of 4 steps of the port's
  fused linear step from the bench's spread initial states.

(a) f64: against the JAX pure path (``_solve_qp_impl`` vmapped with a
    shared A, x64).  Same algorithm, same operands, only the order of f64
    operations differs (measured 5e-15..6e-14 on x, 5e-15..1.2e-13 on the
    multipliers): 1e-10, ok masks equal.
(b) f32: against the Pallas kernel in interpret mode
    (``solve_qp_shared_batched(shared_P=True, band=3)``).  Six unconverged
    interior-point iterations amplify f32 rounding differently in the two
    orderings, so each is held against the f64 solution: on x the port's
    error may be at most twice the kernel's plus 1e-5 (measured 0.7x-1.5x,
    up to 2.2e-4 at closed-loop states); on the multipliers at most twice
    the kernel's plus 2e-5 of their scale (~5; measured 0.7x-4.8x, at
    most 7.7e-5, i.e. 1.5e-5 of the scale, in single seeded lanes); the ok
    masks must be equal.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from koopman_realizations_tpu.ops.pallas.qp_ipm import (
    solve_qp_shared_batched,
)
from koopman_realizations_tpu.ops.qp import _solve_qp_impl

from koopman_realizations_torch.config import ArmConfig, MpcConfig
from koopman_realizations_torch.control.kmpc import LinearKmpc
from koopman_realizations_torch.control.ksim import Ksim
from koopman_realizations_torch.models.arm import Arm
from koopman_realizations_torch.ops.kernels.ipm_shared import (
    ipm_shared_plain,
    solve_qp_shared,
)
from koopman_realizations_torch.ops.kernels.linear_step_fused import (
    build_linear_step_fused,
)
from koopman_realizations_torch.utils.checkpoint import (
    LINEAR_MODEL,
    load_model,
)
from koopman_realizations_torch.utils.trajectories import blockM_reference

from test_torch_oracle import BENCH_ARM, LINEAR_MPC, bench_X0
from test_torch_oracle import one_thread  # noqa: E402,F401  (fixture)

# one torch thread a test process: the xdist workers' pools would
# oversubscribe the machine
pytestmark = pytest.mark.usefixtures("one_thread")

ITERS = LINEAR_MPC["qp_iters"]


def _mpc(dtype):
    model, scaler, _ = load_model(LINEAR_MODEL)
    return LinearKmpc(model, scaler, MpcConfig(**LINEAR_MPC), device="cpu",
                      dtype=dtype)


@pytest.fixture(scope="module")
def mpcs():
    return _mpc(torch.float64), _mpc(torch.float32)


def _seeded(mpc, B, seed):
    """Seeded feasible QPs on the controller's rows, lanes-minor f64:
    (P (n, n), q (n, B), b (mc, B), x_f (n, B))."""
    rng = np.random.default_rng(seed)
    F = mpc.F_red
    mc, n = F.shape
    M = rng.normal(size=(n, n))
    P = 2.0 * (M @ M.T / n + np.diag(rng.uniform(0.05, 1.0, n)))
    q = rng.normal(0, 2.0, (n, B))
    x_f = rng.uniform(-0.05, 0.05, (n, B))
    b = F @ x_f + rng.uniform(0.01, 0.5, (mc, B))
    return P, q, b, x_f


def _closed_loop(mpc64, B):
    """The real QPs at closed-loop states: LinearKmpc.solve's reduced
    problem at the carries of 4 plain fused steps, f64."""
    arm = Arm(ArmConfig(**BENCH_ARM), device="cpu")
    op = build_linear_step_fused(mpc64, arm, mpc64.scaler)
    wins = Ksim(arm, mpc64, device="cpu").reference_windows(
        blockM_reference(), 8)
    fY = op.fYr(wins)
    X0 = bench_X0(B)
    X0[:, 3] = np.linspace(-0.3, 0.3, B)
    c = op.init_carry(X0, np.zeros((B, 2), np.float32))
    for k in range(4):
        c = op.step_plain(c, fY[k])
    z = mpc64.lift(c.ysc)
    f = 2.0 * mpc64.CB_t.T @ (mpc64.Qd_t[:, None]
                              * (mpc64.CA_t @ z - wins[4][:, None]))
    b = mpc64.c_t[:, None] - mpc64.Mc_t @ z
    P, q, bz = mpc64.eliminate_u0(2.0 * mpc64.H_t, f, b, c.upsc)
    return P.numpy(), q.numpy(), bz.numpy(), c.x0.numpy()


def _problem(mpc64, kind, B):
    if kind == "seeded":
        return _seeded(mpc64, B, seed=B)
    return _closed_loop(mpc64, B)


def _port(mpc, P, q, b, x0, warm):
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=mpc.dtype)
    sol = solve_qp_shared(t(P), t(q), mpc.constraints(), t(b),
                          x0=t(x0) if warm else None, iters=ITERS)
    return sol.x.numpy().T, sol.lam.numpy().T, sol.ok.numpy()


CASES = [("seeded", 16, True), ("seeded", 16, False), ("seeded", 13, True),
         ("closed_loop", 16, True), ("closed_loop", 13, True),
         ("closed_loop", 16, False)]


@pytest.mark.parametrize("kind,B,warm", CASES)
def test_f64_matches_jax_pure_path(mpcs, kind, B, warm):
    mpc64, _ = mpcs
    P, q, b, x0 = _problem(mpc64, kind, B)
    x, lam, ok = _port(mpc64, P, q, b, x0, warm)
    A = jnp.asarray(mpc64.F_red)

    def one(qi, bi, xi):
        sol = _solve_qp_impl(jnp.asarray(P), qi, A, bi, ITERS,
                             xi if warm else None, True)
        return sol.x, sol.lam, sol.ok

    jx, jlam, jok = jax.vmap(one)(jnp.asarray(q.T), jnp.asarray(b.T),
                                  jnp.asarray(x0.T))
    assert ok.all() and (ok == np.asarray(jok)).all()
    np.testing.assert_allclose(x, np.asarray(jx), rtol=0, atol=1e-10)
    np.testing.assert_allclose(lam, np.asarray(jlam), rtol=1e-10,
                               atol=1e-10)


@pytest.mark.parametrize("kind,B,warm", CASES)
def test_f32_matches_tpu_kernel_interpret(mpcs, kind, B, warm):
    mpc64, mpc32 = mpcs
    P, q, b, x0 = _problem(mpc64, kind, B)
    x64, lam64, _ = _port(mpc64, P, q, b, x0, warm)
    x, lam, ok = _port(mpc32, P, q, b, x0, warm)
    f = lambda a: jnp.asarray(a, jnp.float32)
    jx, jlam, jok, _ = solve_qp_shared_batched(
        f(P), f(q.T), f(mpc64.F_red), f(b.T), x0=f(x0.T) if warm else None,
        iters=ITERS, interpret=True, tile=8, band=3, shared_P=True)
    jx, jlam, jok = np.asarray(jx), np.asarray(jlam), np.asarray(jok)
    assert x.shape == jx.shape == (B, 12)
    assert ok.all() and (ok == jok).all()
    err_port = np.abs(x - x64).max()
    err_tpu = np.abs(jx - x64).max()
    assert err_port <= 2.0 * err_tpu + 1e-5, (err_port, err_tpu)
    scale = np.abs(lam64).max()
    lerr_port = np.abs(lam - lam64).max()
    lerr_tpu = np.abs(jlam - lam64).max()
    assert lerr_port <= 2.0 * lerr_tpu + 2e-5 * scale, (lerr_port, lerr_tpu)


def test_plain_kernel_outputs(mpcs):
    """The kernel's raw outputs (x, s, lam) have the wrapper's shapes and
    stay interior."""
    mpc64, mpc32 = mpcs
    P, q, b, x0 = _seeded(mpc64, 5, seed=1)
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a),
                                  dtype=torch.float32)
    obj = np.abs(P).max()
    x, s, lam = ipm_shared_plain(mpc32.constraints(), t(P / obj), t(q / obj),
                                 t(b / mpc64.row.numpy()[:, None]), t(x0),
                                 ITERS, 1e-2)
    assert x.shape == (12, 5) and s.shape == lam.shape == (48, 5)
    assert (s > 0).all() and (lam > 0).all()
