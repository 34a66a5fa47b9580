"""The port's plain stage pass (``ops/nmpc.py:stage_pass``, the plain
version of ``csrc/nmpc_stage.cu``) and its wrapper against the JAX
package, and a short closed loop in every SQP regime off the multipass
route.

(a) One pass in each trajectory mode ('hold', 'roll', 'ship'), cold, with
    a per-lane Levenberg term q0, and with q0 and a warm lam0, in f64,
    against an oracle composed from exact JAX pieces fed the port's own
    operands: ``_compose_nonlinear_F`` / ``_compose_poly_jacobian`` of the
    model with W in f64, ``_nmpc_condense_assemble``, ``_factored_Pq`` and
    ``solve_qp``'s pure path with x0 and lam0: 1e-9 on x and the
    multipliers, equal ok masks.
(b) Against ``solve_qp_nmpc_stages``, the JAX route itself (its pure path,
    with the JAX controller's own operands): its Jacobian generator is a
    bf16 hi/lo split (~2^-16 relative) and its dynamics and QP constants
    f32, so the two differ by what that rounding moves in one pass:
    measured 1.2e-5 (hold), 1.3e-6 (roll), 2.5e-6 (ship) on x here; bound
    1e-4.
(c) The wrapper: CPU tensors take the plain version (no launch counted),
    lam0 enters in row units, non-finite x turns to NaN and fails its
    lane, the multipliers return in original units.
(d) The port's general runner in each regime of ``NMPC_REGIMES``, B=4
    over 20 steps in f64: every lane alive, the records finite (the
    regimes' quality against the JAX runner over 301 steps is the card's
    check, ``chip_smoke.py``).

Lanes: scaled outputs of random arm states, random previous inputs inside
the bounds, blockM reference windows of different steps per lane; the
linearization plan is the multipass solve's plan, rho = 0.1.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from koopman_realizations_tpu.control.kmpc import (
    _compose_nonlinear_F,
    _compose_poly_jacobian,
)
from koopman_realizations_tpu.ops.qp import (
    _factored_Pq,
    _nmpc_condense_assemble,
    solve_qp,
    solve_qp_nmpc_stages as jax_solve_qp_nmpc_stages,
)

from koopman_realizations_torch.config import ArmConfig, MpcConfig
from koopman_realizations_torch.control.kmpc import NonlinearKmpc
from koopman_realizations_torch.control.ksim import Ksim
from koopman_realizations_torch.models.arm import Arm
from koopman_realizations_torch.ops import nmpc as N
from koopman_realizations_torch.ops.kernels.nmpc_stage import (
    nmpc_stage,
    nmpc_stage_cuda,
    solve_qp_nmpc_stages,
)
from koopman_realizations_torch.utils.checkpoint import (
    NONLINEAR_MODEL,
    load_model,
)
from koopman_realizations_torch.utils.trajectories import blockM_reference

from test_torch_oracle import (
    BENCH_ARM,
    NMPC_MPC,
    NMPC_REGIMES,
    bench_X0,
    jax_bench,
    nmpc_lanes,
)
from test_torch_oracle import one_thread  # noqa: E402,F401  (fixture)

# one torch thread a test process: the xdist workers' pools would
# oversubscribe the machine
pytestmark = pytest.mark.usefixtures("one_thread")

B = 8
RHO = 0.1


@pytest.fixture(scope="module")
def setup():
    model, scaler, _ = load_model(NONLINEAR_MODEL)
    mpc = NonlinearKmpc(model, scaler, MpcConfig(**NMPC_MPC), device="cpu",
                        dtype=torch.float64)
    zeta, up, sq = nmpc_lanes(B, 11)
    rng = np.random.default_rng(12)
    U, sol = mpc.solve(zeta, up, sq)
    qp = mpc.nmpc_qp(mpc.RdT_t + RHO * mpc.bsizes_t)
    Z = N.rollout(qp, zeta, U)
    # a shipped trajectory off the plan's rollout: the math holds for any
    Zl = Z[:-1] + 0.01 * torch.from_numpy(rng.normal(size=(10, 6, B)))
    ins = dict(zeta=zeta, up=up, sq=sq, U=U, Zl=Zl, Fv=Z[1:],
               x0=mpc.Sel_t @ U[3:], q0=-2.0 * RHO * (mpc.Tb_t.T @ U[3:]),
               lam0=sol.lam)
    _, jmpc, _ = jax_bench("nonlinear")
    return mpc, qp, jmpc, ins


def _traj(mode, d):
    return {"ship": dict(Zl=d["Zl"], Ul=d["U"], Fv=d["Fv"]),
            "roll": dict(Ul=d["U"]), "hold": {}}[mode]


def _oracle(mpc, jmpc, mode, d, q0, lam0):
    """One pass of every lane from exact JAX pieces (f64)."""
    jm = dataclasses.replace(
        jmpc.model, W=jnp.asarray(np.asarray(jmpc.model.W, np.float64)))
    F_fn, J_fn = _compose_nonlinear_F(jm), _compose_poly_jacobian(jm)
    m, Np, nz = mpc.m, mpc.Np, mpc.nz
    rdiag = jnp.asarray(mpc.RdT + RHO * mpc.bsizes)

    def lane(z0, u0, r, Ul, Zl, Fv, x0, q0_, lam0_):
        Ul = Ul.reshape(Np, m)
        if mode == "hold":
            Zl, Ul = jnp.tile(z0[None], (Np, 1)), jnp.tile(u0[None], (Np, 1))
            Fv = jnp.tile(F_fn(z0, u0)[None], (Np, 1))
        elif mode == "roll":
            zs, fs, z = [], [], z0
            for k in range(Np):
                zs.append(z)
                z = F_fn(z, Ul[k])
                fs.append(z)
            Zl, Fv = jnp.stack(zs), jnp.stack(fs)
        J = jax.vmap(J_fn)(Zl, Ul)
        jz, ju = J[..., :nz], J[..., nz:]
        cv = Fv - jnp.einsum("kij,kj->ki", jz, Zl) \
            - jnp.einsum("kij,kj->ki", ju, Ul)
        W, v = _nmpc_condense_assemble(jz, ju, cv, z0, u0, mpc.sqq, r,
                                       mpc.Cz, mpc.cols, m)
        P, q = _factored_Pq(W, v, rdiag, q0_)
        b = jnp.asarray(mpc.cF_red) - jnp.asarray(mpc.F0_red) @ u0
        sol = solve_qp(P, q, jnp.asarray(mpc.F_red), b, iters=8, x0=x0,
                       shared_A=True, backend="jax", lam0=lam0_)
        return sol.x, sol.lam, sol.ok

    T = lambda t: None if t is None else t.numpy().T
    lanes = (T(d["zeta"]), T(d["up"]), T(d["sq"]), T(d["U"]),
             d["Zl"].permute(2, 0, 1).numpy(),
             d["Fv"].permute(2, 0, 1).numpy(), T(d["x0"]), T(q0), T(lam0))
    axes = tuple(None if a is None else 0 for a in lanes)
    return [np.asarray(a) for a in jax.jit(jax.vmap(lane, in_axes=axes))(
        *lanes)]


@pytest.mark.parametrize("variant", ["cold", "q0", "q0_lam0"])
@pytest.mark.parametrize("mode", ["hold", "roll", "ship"])
def test_f64_stage_pass_matches_composed_jax_oracle(setup, mode, variant):
    mpc, qp, jmpc, d = setup
    q0 = None if variant == "cold" else d["q0"]
    lam0 = d["lam0"] if variant == "q0_lam0" else None
    sol = solve_qp_nmpc_stages(qp, mode, d["zeta"], d["up"], d["sq"],
                               x0=d["x0"], q0=q0, lam0=lam0, iters=8,
                               **_traj(mode, d))
    jx, jlam, jok = _oracle(mpc, jmpc, mode, d, q0, lam0)
    np.testing.assert_array_equal(sol.ok.numpy(), jok)
    assert jok.all()
    np.testing.assert_allclose(sol.x.numpy().T, jx, rtol=0, atol=1e-9)
    np.testing.assert_allclose(sol.lam.numpy().T, jlam, rtol=0,
                               atol=1e-9 * max(1.0, np.abs(jlam).max()))


@pytest.mark.parametrize("mode", ["hold", "roll", "ship"])
def test_f64_stage_pass_near_the_jax_route(setup, mode):
    """``solve_qp_nmpc_stages`` of the JAX package with the JAX
    controller's own operands (bf16-split G, f32 dynamics and constants):
    the bound is the split's, see (b) of the module doc."""
    mpc, qp, jmpc, d = setup
    sol = solve_qp_nmpc_stages(qp, mode, d["zeta"], d["up"], d["sq"],
                               x0=d["x0"], q0=d["q0"], lam0=d["lam0"],
                               iters=8, **_traj(mode, d))
    rdiag = jmpc._RdTj + RHO * jmpc._bsizes
    sq = np.sqrt(jmpc.q_diag)

    def lane(z, u, r, Ul, Zl, Fv, x0, q0, lam0):
        s = jax_solve_qp_nmpc_stages(
            Zl, Ul.reshape(10, 3), Fv, z, u, sq, r, jmpc.Cz, rdiag,
            jmpc._Azj, jmpc._cFzj, jmpc._F0j, jmpc._cols, jmpc._stage_ops,
            jmpc._jlayout, iters=8, x0=x0, q0=q0, lam0=lam0,
            band_offset=jmpc._band, roll_mode=mode,
            roll_ops=jmpc._roll_ops, flayout=jmpc._flayout)
        return s.x, s.ok

    T = lambda t: t.numpy().T
    jx, jok = jax.jit(jax.vmap(lane))(
        T(d["zeta"]), T(d["up"]), T(d["sq"]), T(d["U"]),
        d["Zl"].permute(2, 0, 1).numpy(), d["Fv"].permute(2, 0, 1).numpy(),
        T(d["x0"]), T(d["q0"]), T(d["lam0"]))
    np.testing.assert_array_equal(sol.ok.numpy(), np.asarray(jok))
    dx = np.abs(sol.x.numpy().T - np.asarray(jx)).max()
    print(f"{mode}: max |dx| against the JAX route: {dx:.3e}")
    assert 1e-9 < dx < 1e-4, dx


def test_stage_wrapper_dispatch_and_epilogue(setup):
    """CPU tensors take the plain version (no launch is counted); lam0
    enters in row units; a lane whose primal start is not finite turns to
    NaN and fails; the multipliers return in original units."""
    _, qp, _, d = setup
    before = nmpc_stage_cuda.launches
    lam0_row = d["lam0"] * qp.row[:, None]
    x, s, lam, obj = nmpc_stage(qp, "roll", d["zeta"], d["up"], d["sq"],
                                d["x0"], d["q0"], lam0_row, 8, 1e-2,
                                Ul=d["U"])
    assert nmpc_stage_cuda.launches == before
    xbad = d["x0"].clone()
    xbad[0, 2] = float("inf")
    sol = solve_qp_nmpc_stages(qp, "roll", d["zeta"], d["up"], d["sq"],
                               x0=xbad, q0=d["q0"], lam0=d["lam0"],
                               iters=8, Ul=d["U"])
    assert torch.isnan(sol.x[:, 2]).all() and not sol.ok[2]
    keep = torch.arange(B) != 2
    torch.testing.assert_close(sol.x[:, keep], x[:, keep], rtol=0, atol=0)
    torch.testing.assert_close(sol.lam[:, keep],
                               (lam * obj / qp.row[:, None])[:, keep],
                               rtol=0, atol=0)
    assert sol.ok[keep].all()


def test_stage_kernel_takes_only_cuda_f32(setup):
    """The kernel's wrapper refuses CPU tensors (no silent plain run) and
    a mode without its trajectory."""
    _, qp, _, d = setup
    args = (qp, "roll", d["zeta"], d["up"], d["sq"], d["x0"], None, None, 8,
            1e-2)
    with pytest.raises(ValueError):
        nmpc_stage_cuda(*args, Ul=d["U"])
    with pytest.raises(ValueError):
        nmpc_stage_cuda(*args)


@pytest.mark.parametrize("regime", sorted(NMPC_REGIMES))
def test_regime_closed_loop_short(regime):
    model, scaler, _ = load_model(NONLINEAR_MODEL)
    mpc = NonlinearKmpc(model, scaler,
                        MpcConfig(**NMPC_MPC, **NMPC_REGIMES[regime]),
                        device="cpu", dtype=torch.float64)
    sim = Ksim(Arm(ArmConfig(**BENCH_ARM), device="cpu"), mpc, device="cpu")
    out = sim.batched_runner(blockM_reference(), steps=21)(
        bench_X0(4), np.zeros((4, 2), np.float32))
    assert out["Yp"].shape == (4, 20, 2)
    assert out["alive"].all() and torch.isfinite(out["Yp"]).all()
