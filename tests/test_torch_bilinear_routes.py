"""The bilinear controller off the lift-fused route against the JAX
controller: the host constants, ``BilinearKmpc.solve`` in each
configuration of ``BILINEAR_ROUTES``, the re-roll between the passes of
iterated relinearization, the runner's route choice, and a short live
closed loop.

- Host constants: the JAX controller casts PG, PGWb, PG0, PAsq, sqq and
  the blocked stack to the model's f32 and keeps PA, PAt and the
  unblocked stack in f64; the port's f64 constants must equal the JAX
  arrays after the same cast.
- ``solve`` (f64) against ``bilinear_solve_pure`` (x64, the pure path)
  fed the port's f64 values where the JAX controller holds f32 casts:
  the same algorithm on the same operands, so they differ only in the
  order of f64 operations (measured <= 4.9e-13 on the plan, 1.8e-11
  relative on the multipliers): 1e-9.
- The live loop: the port's f64 general runner against the JAX general
  runner, B=4 over 30 blockM steps, step by step.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from koopman_realizations_tpu.control.kmpc import bilinear_solve_pure

from koopman_realizations_torch.config import ArmConfig, MpcConfig
from koopman_realizations_torch.control.kmpc import BilinearKmpc
from koopman_realizations_torch.control.ksim import Ksim
from koopman_realizations_torch.models.arm import Arm
from koopman_realizations_torch.ops.kernels.step_fused import (
    build_step_fused,
)
from koopman_realizations_torch.utils.checkpoint import load_model
from koopman_realizations_torch.utils.trajectories import blockM_reference

from test_torch_oracle import (
    BENCH_ARM,
    BENCH_MPC,
    BILINEAR_ROUTES,
    bench_X0,
    bilinear_lanes,
    blockM_y,
    jax_bilinear,
    one_thread,  # noqa: F401  (the fixture of pytestmark)
)

pytestmark = pytest.mark.usefixtures("one_thread")


def _port(name, dtype=torch.float64):
    model, scaler, _ = load_model()
    return BilinearKmpc(model, scaler,
                        MpcConfig(**{**BENCH_MPC, **BILINEAR_ROUTES[name]}),
                        device="cpu", dtype=dtype)


@pytest.fixture(scope="module")
def arm():
    return Arm(ArmConfig(**BENCH_ARM), device="cpu")


@pytest.mark.parametrize("name", list(BILINEAR_ROUTES))
def test_host_constants_match_jax(name):
    port = _port(name)
    _, jmpc = jax_bilinear(**BILINEAR_ROUTES[name])
    c = jmpc.consts()
    f32 = lambda a: np.asarray(a).astype(np.float32)
    g = port.gens_host
    assert not port.lift_fused and jmpc._lift_gens is None
    for key in ("PA", "PAt"):
        np.testing.assert_allclose(g[key], np.asarray(c[key]), rtol=0,
                                   atol=1e-12, err_msg=key)
    keys = ("PG",) + (("PGWb", "PG0", "PAsq") if port.blocked else ())
    for key in keys:
        jv = np.asarray(c[key])
        assert jv.dtype == np.float32
        np.testing.assert_array_equal(f32(g[key]).reshape(jv.shape), jv,
                                      err_msg=key)
    assert port.band == jmpc._band and port.n_con == jmpc.n_con
    if port.blocked:
        assert port.band == 3 and port.A.shape == (48, 12)
        for key, v in (("FjT", port.F_red), ("cFjT", port.cF_red),
                       ("F0T", port.F0_red), ("RdT", port.RdT),
                       ("sqq", port.sqq)):
            np.testing.assert_array_equal(f32(v), np.asarray(c[key]),
                                          err_msg=key)
        return
    m = port.m
    np.testing.assert_array_equal(port.F_red, np.asarray(c["Fj"])[:, m:])
    np.testing.assert_array_equal(port.F0_red, np.asarray(c["Fj"])[:, :m])
    np.testing.assert_array_equal(port.cF_red, np.asarray(c["cFj"]))
    np.testing.assert_array_equal(port.rdiag.numpy(),
                                  np.asarray(c["Rd"])[m:])
    smooth = BILINEAR_ROUTES[name].get("input_smoothConst") is not None
    assert port.A.shape == ((156, 27) if smooth else (108, 27))
    assert port.band == (None if smooth else 3)
    # the dense build's row table: every nonzero of A, columns ascending
    if smooth:
        A = port.A.numpy()
        assert len(port.dense_cols) == 156
        assert max(sum(c >= 0 for c in r) for r in port.dense_cols) == 3
        for c, cols in enumerate(port.dense_cols):
            live = [k for k in cols if k >= 0]
            assert live == sorted(live) == list(np.flatnonzero(A[c]))
            np.testing.assert_array_equal(port.Wd.numpy()[c, :len(live)],
                                          A[c, live])


def _jax_consts(port, jmpc):
    """The JAX controller's constants with the port's f64 values in place
    of its f32 casts."""
    c = dict(jmpc.consts())
    g = port.gens_host
    c["PG"] = g["PG"]
    if port.blocked:
        c.update(FjT=port.F_red, cFjT=port.cF_red, F0T=port.F0_red,
                 RdT=port.RdT, sqq=port.sqq,
                 **{k: g[k] for k in ("PGWb", "PG0", "PAsq")})
    return {k: jnp.asarray(v) for k, v in c.items()}


@pytest.mark.parametrize("warm", [False, True])
@pytest.mark.parametrize("name", list(BILINEAR_ROUTES))
def test_solve_matches_jax_controller(name, warm):
    port = _port(name)
    _, jmpc = jax_bilinear(**BILINEAR_ROUTES[name])
    z, up, U, lam, refhor, sqYr = bilinear_lanes(port, 8, seed=3 + warm)
    cfg = port.cfg
    Up, sol = port.solve(z, up, sqYr, U, lam if warm else None)
    c = _jax_consts(port, jmpc)

    def one(zl, ul, ref, Ul, laml):
        return bilinear_solve_pure(
            c, zl, ul, ref, Ul.reshape(port.Np, port.m), Np=port.Np,
            m=port.m, n=port.n, nproj=port.nproj, qp_iters=cfg.qp_iters,
            iters=cfg.bilinear_iters, backend=jmpc.cfg.qp_backend,
            band=jmpc._band, lam_init=laml if warm else None)

    jU, jok, jlam = jax.vmap(one)(*(jnp.asarray(a) for a in (
        z.T.numpy(), up.T.numpy(), refhor, U.T.numpy(), lam.T.numpy())))
    assert sol.ok.all() and (sol.ok.numpy() == np.asarray(jok)).all()
    np.testing.assert_allclose(Up.T.numpy(),
                               np.asarray(jU).reshape(8, -1), rtol=0,
                               atol=1e-9)
    np.testing.assert_allclose(sol.lam.T.numpy(), np.asarray(jlam),
                               rtol=1e-9, atol=1e-9)


def test_iterated_relinearization_pieces_match_jax():
    """The re-rolled lifted trajectory and the second pass's W and v of
    ``iters2`` against the JAX controller's formulas on its constants
    (kmpc.py:607-647, 749-754): the scan z_{k+1} = A z_k + Bm(z_k, u_k),
    the stage Betas, the block-Toeplitz CB and W = sqrt(Q) CB[:, m:] Tb,
    v = sqrt(Q) (CA z - Yr + CB[:, :m] u_prev)."""
    port = _port("iters2")
    _, jmpc = jax_bilinear(**BILINEAR_ROUTES["iters2"])
    c = jmpc.consts()
    Np, m, nproj = port.Np, port.m, port.nproj
    z, up, U, _, refhor, sqYr = bilinear_lanes(port, 4, seed=7)
    zs, betas = port.roll(z, U)
    W, v = port.factored_data(z, up, sqYr, betas)

    def jax_pieces(zl, ul, Ul, ref):
        def roll(zc, u):
            return c["A"] @ zc + jnp.einsum("kmj,j,m->k", c["Bm"], zc,
                                            u), zc
        _, zhor = jax.lax.scan(roll, zl, Ul.reshape(Np, m))
        Beta_j = jnp.einsum("kmj,pj->pkm", c["Bm"], zhor)
        g = jnp.einsum("ijrb,jbm->ijrm", c["PAt"], Beta_j)
        CB = g.transpose(0, 2, 1, 3).reshape((Np + 1) * nproj, Np * m)
        sq = jnp.sqrt(c["Qd"])
        Wj = (sq[:, None] * CB[:, m:]) @ c["Tb"]
        vj = sq * ((c["PA"] @ zl).reshape(-1) - ref.reshape(-1)
                   + CB[:, :m] @ ul)
        return zhor, Beta_j, Wj, vj

    jz, jB, jW, jv = jax.vmap(jax_pieces)(*(jnp.asarray(a) for a in (
        z.T.numpy(), up.T.numpy(), U.T.numpy(), refhor)))
    np.testing.assert_allclose(zs.permute(2, 0, 1).numpy(), np.asarray(jz),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(betas.permute(3, 0, 1, 2).numpy(),
                               np.asarray(jB), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(W.permute(2, 0, 1).numpy(), np.asarray(jW),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(v.T.numpy(), np.asarray(jv), rtol=1e-12,
                               atol=1e-12)


@pytest.mark.parametrize("name", ["iters2", "unblocked"])
def test_runner_takes_the_general_route(arm, name):
    """Off the lift-fused route the fused step does not apply (JAX
    ``ksim.py:423-428`` requires the lift-fused generators): no fused
    runner, no fused-step operands, no lift-fused QP; the general runner
    lifts zeta on the host."""
    for dtype in (torch.float32, torch.float64):
        port = _port(name, dtype)
        sim = Ksim(arm, port, device="cpu")
        assert not port.wants_zeta
        assert not sim.fused_step_eligible()
        with pytest.raises(ValueError):
            sim.fused_runner(blockM_reference(), steps=5)
        with pytest.raises(NotImplementedError):
            port.lift_qp()
        with pytest.raises(NotImplementedError):
            build_step_fused(port, arm, port.scaler)
    lf = BilinearKmpc(port.model, port.scaler, MpcConfig(**BENCH_MPC),
                      device="cpu")
    assert lf.lift_fused and lf.wants_zeta
    assert Ksim(arm, lf, device="cpu").fused_step_eligible()


@pytest.mark.parametrize("extra", [
    dict(state_bounds=(-1.0, 1.0)),
    dict(state_bounds=(-1.0, 1.0), qp_dual_shift=True),
    dict(mpc_type="nonlinear"), dict(input_smoothConst=0.1),
    dict(state_bounds=(-1.0, 1.0), bilinear_iters=2),
    dict(bilinear_iters=-1), dict(bilinear_iters=0)])
def test_bilinear_controller_refuses_what_is_not_ported(extra):
    """Bilinear-as-NMPC raises here (``NonlinearKmpc`` takes it), and so
    do no pass at all and, as in the JAX controller, blocks with state
    bounds or smoothness (state bounds and the dual shift on the
    unblocked stack: ``tests/test_torch_knobs.py``)."""
    model, scaler, _ = load_model()
    with pytest.raises(NotImplementedError):
        BilinearKmpc(model, scaler, MpcConfig(**{**BENCH_MPC, **extra}),
                     device="cpu")


def test_bilinear_controller_refuses_loads():
    """A loaded model leaves the lift-fused route for the z route of every
    configuration (its lifted state carries the load estimate),
    tests/test_torch_loaded.py; with delays too (the loaded delayed
    asset, nzeta = 10: tests/test_torch_loaded_delays.py)."""
    from koopman_realizations_torch.utils.checkpoint import (
        LOADED_BILINEAR_MODEL,
        LOADED_DELAYED_MODEL,
    )
    for path, nd in ((LOADED_BILINEAR_MODEL, 0), (LOADED_DELAYED_MODEL, 1)):
        lmodel, lscaler, _ = load_model(path)
        for knobs in [{}] + list(BILINEAR_ROUTES.values()):
            cfg = MpcConfig(**{**BENCH_MPC, "proj_idx": (2, 3),
                               "cost_input": (3e-3, 2e-3), **knobs})
            mpc = BilinearKmpc(lmodel, lscaler, cfg, device="cpu")
            assert not mpc.lift_fused and mpc.meta.nd == nd
            assert mpc.NL == lmodel.meta.N * 3 and (nd or mpc.NL == 42)


def test_short_closed_loop_matches_live_jax(arm):
    """The port's f64 general runner against the JAX general runner
    (x64) in the ``iters2`` configuration (both kinds of pass and the
    re-roll between them), B=4 over 30 blockM steps, every step's tracked
    outputs: the JAX controller's f32 constants against the port's f64
    (~1e-7 relative) move them by at most 7.0e-8 (measured); bound
    1e-6."""
    B, steps, name = 4, 30, "iters2"
    sim, _ = jax_bilinear(**BILINEAR_ROUTES[name])
    run = sim.batched_runner(blockM_y(), steps=steps, record=("Yp", "alive"))
    jout = jax.block_until_ready(run(bench_X0(B), np.zeros((B, 2),
                                                           np.float32)))
    out = Ksim(arm, _port(name), device="cpu").batched_runner(
        blockM_reference(), steps=steps)(bench_X0(B),
                                          np.zeros((B, 2), np.float32))
    assert out["alive"].all() and np.asarray(jout["alive"]).all()
    np.testing.assert_allclose(out["Yp"].numpy(), np.asarray(jout["Yp"]),
                               rtol=0, atol=1e-6)
