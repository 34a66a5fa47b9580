"""``bilin_plain`` (and the ``solve_qp_bilinear`` epilogue) against the
JAX assembly-fused bilinear solve, the first pass of iterated
relinearization, at B=16 and at a B that no tile divides, with cold and
warm starts; and the ``iters2`` closed loop.

(a) f64: against exact JAX pieces (``_bilin_assemble`` ->
    ``_factored_Pq`` -> ``_solve_qp_impl``, x64: the pure path of
    ``solve_qp_bilinear``) on the same f64 operands, so they differ only
    in the order of f64 operations: 1e-9.
(b) f32: against the Pallas kernel in interpret mode
    (``solve_qp_bilinear_batched``), whose assembly runs as 3-pass bf16
    hi/lo GEMMs (~1e-6 relative) where the port's is f32 FMAs, on the JAX
    controller's f32 constants.  The bound is stated against the f64
    solution: the port's f32 error may be at most twice the TPU kernel's
    plus 1e-5 (measured 9e-7..4.6e-6 against the split's 4.3e-5..1.9e-4),
    and the ok masks must be equal.
(c) The port's f64 general runner in the ``iters2`` configuration, B=16
    over 301 blockM steps, against the JAX general runner's err_mean
    (``assets/bilinear_route_refs.json``): the JAX controller keeps its
    blocked stack, generators and sqrt(Q) in f32 in its x64 session, the
    port in f64 (measured difference 1.9e-6; bound 1e-5, as the
    lift-fused loop's), alive equal.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from koopman_realizations_tpu.ops.pallas.qp_ipm import (
    solve_qp_bilinear_batched,
)
from koopman_realizations_tpu.ops.qp import (
    _bilin_assemble,
    _factored_Pq,
    _solve_qp_impl,
)

from koopman_realizations_torch.config import ArmConfig, MpcConfig
from koopman_realizations_torch.control.kmpc import BilinearKmpc
from koopman_realizations_torch.control.ksim import Ksim
from koopman_realizations_torch.models.arm import Arm
from koopman_realizations_torch.ops.kernels.bilin import (
    bilin_plain,
    solve_qp_bilinear,
)
from koopman_realizations_torch.utils.checkpoint import load_model
from koopman_realizations_torch.utils.metrics import lane_tracking_error
from koopman_realizations_torch.utils.trajectories import blockM_reference

from test_torch_oracle import (
    BENCH_ARM,
    BENCH_MPC,
    BILINEAR_ROUTE_REFS,
    BILINEAR_ROUTES,
    REF_B,
    REF_STEPS,
    bench_X0,
    bilinear_lanes,
    jax_bilinear,
    one_thread,  # noqa: F401  (the fixture of pytestmark)
)

pytestmark = pytest.mark.usefixtures("one_thread")

CFG = {**BENCH_MPC, **BILINEAR_ROUTES["iters2"]}


@pytest.fixture(scope="module")
def setup():
    model, scaler, _ = load_model()
    mpc = {dt: BilinearKmpc(model, scaler, MpcConfig(**CFG), device="cpu",
                            dtype=dt)
           for dt in (torch.float32, torch.float64)}
    _, jmpc = jax_bilinear(**BILINEAR_ROUTES["iters2"])
    return mpc, jmpc


def _port(mpc, lanes, warm_x, warm_lam, dtype):
    z, up, U, lam, _, sqYr = (t.to(dtype) if torch.is_tensor(t) else t
                              for t in lanes)
    sol = solve_qp_bilinear(mpc.bilin_qp(), z, up, sqYr,
                            x0=mpc.warm_start(U) if warm_x else None,
                            lam0=lam if warm_lam else None, iters=4)
    return sol.x.numpy().T, sol.lam.numpy().T, sol.ok.numpy()


CASES = [(16, True, True), (16, True, False), (16, False, False),
         (13, True, True)]


@pytest.mark.parametrize("B,warm_x,warm_lam", CASES)
def test_f64_matches_jax_pieces(setup, B, warm_x, warm_lam):
    mpc, _ = setup
    m64 = mpc[torch.float64]
    lanes = bilinear_lanes(m64, B, seed=B + 2 * warm_lam)
    z, up, U, lam, _, sqYr = lanes
    x, jl, ok = _port(m64, lanes, warm_x, warm_lam, torch.float64)
    g = m64.gens_host
    ones = jnp.ones(m64.p)

    def one(zl, ul, sq, x0, lam0):
        W, v, b = _bilin_assemble(zl, ul, sq, g["PGWb"], g["PG0"],
                                  g["PAsq"], ones, m64.cF_red, m64.F0_red)
        P, q = _factored_Pq(W, v, m64.RdT)
        return _solve_qp_impl(P, q, m64.F_red, b, 4,
                              x0 if warm_x else None, True,
                              lam0 if warm_lam else None)

    sol = jax.vmap(one)(*(jnp.asarray(a.T.numpy()) for a in (
        z, up, sqYr, m64.warm_start(U), lam)))
    assert ok.all() and (ok == np.asarray(sol.ok)).all()
    np.testing.assert_allclose(x, np.asarray(sol.x), rtol=0, atol=1e-9)
    np.testing.assert_allclose(jl, np.asarray(sol.lam), rtol=1e-9,
                               atol=1e-9)


@pytest.mark.parametrize("B,warm_x,warm_lam", CASES)
def test_f32_matches_tpu_kernel_interpret(setup, B, warm_x, warm_lam):
    mpc, jmpc = setup
    lanes = bilinear_lanes(mpc[torch.float64], B, seed=B + 2 * warm_lam)
    z, up, U, lam, _, sqYr = lanes
    x64, lam64, _ = _port(mpc[torch.float64], lanes, warm_x, warm_lam,
                          torch.float64)
    x, jl, ok = _port(mpc[torch.float32], lanes, warm_x, warm_lam,
                      torch.float32)
    c = jmpc.consts()
    f = lambda a: jnp.asarray(a.T.numpy(), jnp.float32)
    jx, jlam, jok, _ = solve_qp_bilinear_batched(
        f(z), f(up), f(sqYr), c["PGWb"], c["PG0"], c["PAsq"], c["RdT"],
        c["FjT"], c["cFjT"], c["F0T"],
        x0=f(mpc[torch.float64].warm_start(U)) if warm_x else None,
        iters=4, interpret=True, tile=8, band=jmpc._band,
        lam0=f(lam) if warm_lam else None)
    jx, jlam, jok = np.asarray(jx), np.asarray(jlam), np.asarray(jok)
    assert x.shape == jx.shape == (B, 12)
    assert ok.all() and (ok == jok).all()
    err_port = np.abs(x - x64).max()
    err_tpu = np.abs(jx - x64).max()
    assert err_port <= 2.0 * err_tpu + 1e-5, (err_port, err_tpu)
    lam_scale = np.abs(lam64).max()
    assert np.abs(jl - lam64).max() <= \
        2.0 * np.abs(jlam - lam64).max() + 1e-5 * lam_scale


def test_plain_core_outputs(setup):
    """The kernel's raw outputs (x, s, lam, obj) have the wrapper's
    shapes and a positive objective scale."""
    mpc, _ = setup
    m32 = mpc[torch.float32]
    z, up, U, _, _, sqYr = bilinear_lanes(mpc[torch.float64], 5, seed=1)
    z, up, U, sqYr = (t.float() for t in (z, up, U, sqYr))
    x, s, lam, obj = bilin_plain(m32.bilin_qp(), z, up, m32.warm_start(U),
                                 None, sqYr, 4, 1e-2)
    assert x.shape == (12, 5) and s.shape == lam.shape == (48, 5)
    assert (obj > 0).all() and (s > 0).all() and (lam > 0).all()


def test_iters2_closed_loop_matches_jax_reference():
    ref = json.loads(BILINEAR_ROUTE_REFS.read_text())["regimes"]["iters2"]
    model, scaler, _ = load_model()
    mpc = BilinearKmpc(model, scaler, MpcConfig(**CFG), device="cpu",
                       dtype=torch.float64)
    sim = Ksim(Arm(ArmConfig(**BENCH_ARM), device="cpu"), mpc, device="cpu")
    out = sim.batched_runner(blockM_reference(), steps=REF_STEPS)(
        bench_X0(REF_B), np.zeros((REF_B, 2), np.float32))
    err = lane_tracking_error(out["Yp"], blockM_reference()).numpy()
    assert out["alive"][:, -1].double().mean().item() == ref["alive"] == 1.0
    assert abs(err.mean() - ref["err_mean"]) < 1e-5, (err.mean(),
                                                      ref["err_mean"])
