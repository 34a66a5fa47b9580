"""``bilin_lift_plain`` (and the ``solve_qp_bilinear_lifted`` epilogue)
against the JAX lift-fused solve, at B=16 and at a B that no tile divides,
with warm and cold starts.

(a) f64: against the JAX pure path (``_solve_qp_bilinear_lifted`` with
    ``backend="jax"``, x64).  Both sides get the same f32-valued operands,
    so they differ only in the order of f64 operations (measured 1e-14 on
    x, 5e-14 on the multipliers): 1e-10.
(b) f32: against the Pallas kernel in interpret mode
    (``solve_qp_bilinear_lifted_batched``), whose assembly runs as 3-pass
    bf16 GEMMs (~1e-6 relative) where the port's is full f32; four
    unconverged Mehrotra iterations amplify that.  The bound is stated
    against the f64 solution: the port's f32 error may be at most twice
    the TPU kernel's plus 1e-5 (measured: 2e-6..8e-6 against the
    kernel's 3e-5..1.2e-4), and the ok masks must be equal.

Both hold also with a different reference window in every lane (sqYr of
shape (p, B)), which the port's kernels take as the JAX ones do.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from koopman_realizations_tpu.ops.pallas.qp_ipm import (
    solve_qp_bilinear_lifted_batched,
)
from koopman_realizations_tpu.ops.qp import _solve_qp_bilinear_lifted

from koopman_realizations_torch.config import ArmConfig, MpcConfig
from koopman_realizations_torch.control.kmpc import BilinearKmpc
from koopman_realizations_torch.models.arm import Arm
from koopman_realizations_torch.ops.kernels.bilin_lift import (
    bilin_lift_plain,
    solve_qp_bilinear_lifted,
)
from koopman_realizations_torch.ops.qp import lift_qp_operands
from koopman_realizations_torch.utils.checkpoint import load_model

from test_torch_oracle import BENCH_ARM, BENCH_MPC, blockM_y, jax_bench
from test_torch_oracle import one_thread  # noqa: E402,F401  (fixture)

# one torch thread a test process: the xdist workers' pools would
# oversubscribe the machine
pytestmark = pytest.mark.usefixtures("one_thread")

GEN_KEYS = ("Gz", "Gm", "Gb", "Hz", "Hm", "Hb", "Pz", "Pm", "Pb")


@pytest.fixture(scope="module")
def setup():
    model, scaler, _ = load_model()
    mpc = BilinearKmpc(model, scaler, MpcConfig(**BENCH_MPC), device="cpu")
    f32 = lambda a: np.asarray(a, np.float32).astype(np.float64)
    qp64 = lift_qp_operands({k: f32(v) for k, v in mpc.lift_gens.items()},
                            mpc.lift_tables, f32(mpc.RdT), f32(mpc.F_red),
                            f32(mpc.cF_red), f32(mpc.F0_red), mpc.band,
                            dtype=torch.float64, device="cpu")
    _, jmpc, _ = jax_bench()
    return mpc, qp64, jmpc


def _inputs(mpc, B, seed, per_lane=False):
    """Closed-loop-like lane inputs: scaled outputs of random arm states,
    scaled previous inputs, a held-input primal start, positive duals in
    original units, and the reference window of a random step (per lane:
    windows 11 steps apart, (B, p))."""
    rng = np.random.default_rng(seed)
    arm = Arm(ArmConfig(**BENCH_ARM), device="cpu")
    X = np.concatenate([rng.normal(0, 0.25, (B, 3)),
                        np.zeros((B, 3))], axis=1)
    y = arm.get_y(torch.from_numpy(X.T.copy())).numpy()
    zeta = mpc.scaler.y_down(y.T)                              # (B, nz)
    u = rng.uniform(-0.3, 0.3, (B, mpc.m))
    x0 = np.tile(u, (1, len(mpc.cfg.input_blocks)))            # (B, n)
    lam0 = np.exp(rng.normal(-1.0, 1.0, (B, mpc.n_con)))
    ref = mpc.scaler.ref_down(blockM_y(), mpc.proj_idx)
    k = int(rng.integers(0, ref.shape[0] - mpc.Np - 1))
    sqYr = mpc.sqq * ref[k:k + mpc.Np + 1].reshape(-1)
    if per_lane:
        ks = (k + 11 * np.arange(B)) % (ref.shape[0] - mpc.Np - 1)
        sqYr = np.stack([mpc.sqq * ref[j:j + mpc.Np + 1].reshape(-1)
                         for j in ks])
    return zeta, u, x0, lam0, sqYr


def _port(qp, zeta, u, x0, lam0, sqYr, warm_x, warm_lam, dtype):
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=dtype)
    sol = solve_qp_bilinear_lifted(
        qp, t(zeta.T), t(u.T), t(sqYr.T), x0=t(x0.T) if warm_x else None,
        lam0=t(lam0.T) if warm_lam else None, iters=4)
    return sol.x.numpy().T, sol.lam.numpy().T, sol.ok.numpy()


def _jax_pure(jmpc, zeta, u, x0, lam0, sqYr, warm_x, warm_lam):
    c = jmpc.consts()
    gens = [c["LF_" + k] for k in GEN_KEYS]

    def one(z, up, x, lam, sq):
        return _solve_qp_bilinear_lifted(
            z, up, sq, *gens, c["RdT"], c["FjT"], c["cFjT"],
            c["F0T"], jmpc._lift_tables, 4, x if warm_x else None, "jax",
            jmpc._band, lam if warm_lam else None)

    sol = jax.vmap(one, in_axes=(0, 0, 0, 0, 0 if sqYr.ndim == 2 else None))(
        jnp.asarray(zeta), jnp.asarray(u), jnp.asarray(x0),
        jnp.asarray(lam0), jnp.asarray(sqYr))
    return np.asarray(sol.x), np.asarray(sol.lam), np.asarray(sol.ok)


CASES = [(16, True, True), (16, True, False), (16, False, False),
         (13, True, True)]


@pytest.mark.parametrize("B,warm_x,warm_lam", CASES)
def test_f64_matches_jax_pure_path(setup, B, warm_x, warm_lam):
    _check_f64(setup, B, warm_x, warm_lam, per_lane=False)


@pytest.mark.parametrize("B,warm_x,warm_lam", CASES[::3])
def test_f64_per_lane_windows_match_jax_pure_path(setup, B, warm_x,
                                                  warm_lam):
    _check_f64(setup, B, warm_x, warm_lam, per_lane=True)


def _check_f64(setup, B, warm_x, warm_lam, per_lane):
    mpc, qp64, jmpc = setup
    zeta, u, x0, lam0, sqYr = _inputs(mpc, B, seed=B + 2 * warm_lam,
                                      per_lane=per_lane)
    x, lam, ok = _port(qp64, zeta, u, x0, lam0, sqYr, warm_x, warm_lam,
                       torch.float64)
    jx, jlam, jok = _jax_pure(jmpc, zeta, u, x0, lam0, sqYr, warm_x,
                              warm_lam)
    assert ok.all() and (ok == jok).all()
    np.testing.assert_allclose(x, jx, rtol=0, atol=1e-10)
    np.testing.assert_allclose(lam, jlam, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("B,warm_x,warm_lam", CASES)
def test_f32_matches_tpu_kernel_interpret(setup, B, warm_x, warm_lam):
    _check_f32(setup, B, warm_x, warm_lam, per_lane=False)


@pytest.mark.parametrize("B,warm_x,warm_lam", CASES[::3])
def test_f32_per_lane_windows_match_tpu_kernel_interpret(setup, B, warm_x,
                                                         warm_lam):
    _check_f32(setup, B, warm_x, warm_lam, per_lane=True)


def _check_f32(setup, B, warm_x, warm_lam, per_lane):
    mpc, qp64, jmpc = setup
    zeta, u, x0, lam0, sqYr = _inputs(mpc, B, seed=B + 2 * warm_lam,
                                      per_lane=per_lane)
    x64, lam64, _ = _port(qp64, zeta, u, x0, lam0, sqYr, warm_x, warm_lam,
                          torch.float64)
    x, lam, ok = _port(mpc.lift_qp(), zeta, u, x0, lam0, sqYr, warm_x,
                       warm_lam, torch.float32)
    c = jmpc.consts()
    f = lambda a: jnp.asarray(a, jnp.float32)
    jx, jlam, jok, _ = solve_qp_bilinear_lifted_batched(
        f(zeta), f(u), f(sqYr), *(c["LF_" + k] for k in GEN_KEYS),
        c["RdT"], c["FjT"], c["cFjT"], c["F0T"],
        x0=f(x0) if warm_x else None, iters=4, tables=jmpc._lift_tables,
        interpret=True, tile=8, band=jmpc._band,
        lam0=f(lam0) if warm_lam else None)
    jx, jlam, jok = np.asarray(jx), np.asarray(jlam), np.asarray(jok)
    assert x.shape == jx.shape == (B, 12)
    assert ok.all() and (ok == jok).all()
    err_port = np.abs(x - x64).max()
    err_tpu = np.abs(jx - x64).max()
    assert err_port <= 2.0 * err_tpu + 1e-5, (err_port, err_tpu)
    lam_scale = np.abs(lam64).max()
    assert np.abs(lam - lam64).max() <= \
        2.0 * np.abs(jlam - lam64).max() + 1e-5 * lam_scale


def test_plain_core_outputs(setup):
    """The kernel's raw outputs (x, s, lam, obj) have the wrapper's
    shapes and a positive objective scale."""
    mpc, _, _ = setup
    zeta, u, x0, lam0, sqYr = _inputs(mpc, 5, seed=1)
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a.T),
                                  dtype=torch.float32)
    x, s, lam, obj = bilin_lift_plain(
        mpc.lift_qp(), t(zeta), t(u), t(x0), None,
        torch.as_tensor(sqYr, dtype=torch.float32), 4, 1e-2)
    assert x.shape == (12, 5) and s.shape == lam.shape == (48, 5)
    assert (obj > 0).all() and (s > 0).all() and (lam > 0).all()
