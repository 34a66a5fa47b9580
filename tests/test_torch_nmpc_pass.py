"""The port's chord pass (``ops/nmpc.py:jacobian_pass``, the plain version
of ``csrc/nmpc_pass.cu``), its wrapper, the per-pass pieces of the SQP
(``stage_lin``, the rollout, the merit, the line search) and the chord
route's solves against the JAX package.

(a) One pass from shipped stage Jacobians, fresh at the plan's rollout or
    frozen at the held state with fresh defects, cold or with q0 and a
    warm lam0, in f64, against ``solve_qp_nmpc``'s pure path fed the same
    Jacobians and the port's operands: 1e-9 on x and the multipliers,
    equal ok masks.
(b) The chord route against the JAX one with the JAX controller's own
    operands (``_stage_lin`` with the composed maps in f32, constants in
    f32): measured 1.0e-8 (fresh), 5.2e-7 (frozen) on x; bound 1e-4.
(c) ``stage_lin``, ``_rollout_full``, ``_cost_from_Z``, ``_roll_cost`` and
    ``_line_search`` against the JAX controller's methods with the model's
    W in f64 (the JAX controller casts its composed maps to the model's
    dtype): 1e-12 (the merit relative to its size).
(d) The stale condensation: frozen Jacobians at an unmoved point give the
    fresh pass exactly (``tests/test_closed_loop.py:292`` of the JAX
    package); at a moved point the frozen affine recursion equals the JAX
    ``_condense_stale``'s.
(e) ``NonlinearKmpc.solve`` on the chord route (``sqp_jac_period`` 2 and
    3, alone and with warm duals, best-of-passes and the line search)
    in f64 against the JAX controller on the same lanes: measured at most
    5.9e-5 on the plan (the JAX controller's f32 constants and maps through
    five nonconvex passes); bound 1e-4, equal ok masks.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from koopman_realizations_tpu.config import MpcConfig as JMpcConfig
from koopman_realizations_tpu.control import make_kmpc
from koopman_realizations_tpu.ops.qp import (
    solve_qp_nmpc as jax_solve_qp_nmpc,
)

from koopman_realizations_torch.config import MpcConfig
from koopman_realizations_torch.control.kmpc import NonlinearKmpc
from koopman_realizations_torch.ops import nmpc as N
from koopman_realizations_torch.ops.kernels.nmpc_pass import (
    nmpc_pass,
    nmpc_pass_cuda,
    solve_qp_nmpc_pass,
)
from koopman_realizations_torch.utils.checkpoint import (
    NONLINEAR_MODEL,
    load_model,
)

from test_torch_oracle import (
    NMPC_MPC,
    jax_bench,
    jax_model,
    jax_nmpc,
    nmpc_lanes,
)
from test_torch_oracle import one_thread  # noqa: E402,F401  (fixture)

# one torch thread a test process: the xdist workers' pools would
# oversubscribe the machine
pytestmark = pytest.mark.usefixtures("one_thread")

B = 8
RHO = 0.1
LS = dict(sqp_linesearch=2)


@pytest.fixture(scope="module")
def setup():
    model, scaler, _ = load_model(NONLINEAR_MODEL)
    mpc = NonlinearKmpc(model, scaler, MpcConfig(**NMPC_MPC, **LS),
                        device="cpu", dtype=torch.float64)
    zeta, up, sq = nmpc_lanes(B, 21)
    U, sol = mpc.solve(zeta, up, sq)
    qp = mpc.nmpc_qp(mpc.RdT_t + RHO * mpc.bsizes_t)
    Z = N.rollout(qp, zeta, U)
    Zh, Uh = zeta.expand((10,) + zeta.shape), up.repeat(10, 1)
    Jh, _ = N.stage_lin(qp, Zh, Uh)
    jacs = {"fresh": N.stage_lin(qp, Z[:-1], U, Fv=Z[1:]),
            "frozen": N.stage_lin(qp, Z[:-1], U, frozen=Jh, Fv=Z[1:])}
    d = dict(zeta=zeta, up=up, sq=sq, U=U, Z=Z, Zh=Zh, Uh=Uh, Jh=Jh,
             x0=mpc.Sel_t @ U[3:], q0=-2.0 * RHO * (mpc.Tb_t.T @ U[3:]),
             lam0=sol.lam, ref=sq / torch.from_numpy(mpc.sqq)[:, None])
    jm, jscaler = jax_model("nonlinear")
    jm64 = dataclasses.replace(
        jm, W=jnp.asarray(np.asarray(jm.W, np.float64)))
    jmpc64 = make_kmpc(jm64, jscaler, JMpcConfig(**NMPC_MPC, **LS))
    return mpc, qp, jacs, d, jmpc64


T = lambda t: None if t is None else t.numpy().T
lanes3 = lambda t: t.permute(2, 0, 1).numpy()          # (.., .., B) -> B first


def _jz_ju(jt):
    """One lane's Jt (Np, nza, nz) as the JAX package's jz, ju."""
    return jt[:, :6].transpose(0, 2, 1), jt[:, 6:].transpose(0, 2, 1)


@pytest.mark.parametrize("warm", [False, True])
@pytest.mark.parametrize("jac", ["fresh", "frozen"])
def test_f64_chord_pass_matches_jax_solve_qp_nmpc(setup, jac, warm):
    mpc, qp, jacs, d, _ = setup
    Jt, cv = jacs[jac]
    q0, lam0 = (d["q0"], d["lam0"]) if warm else (None, None)
    sol = solve_qp_nmpc_pass(qp, Jt, cv, d["zeta"], d["up"], d["sq"],
                             x0=d["x0"], q0=q0, lam0=lam0, iters=8)
    rdiag = mpc.RdT + RHO * mpc.bsizes

    def lane(jt, c, z, u, r, x0, q0_, lam0_):
        jz, ju = _jz_ju(jt)
        s = jax_solve_qp_nmpc(jz, ju, c, z, u, mpc.sqq, r, mpc.Cz, rdiag,
                              mpc.F_red, mpc.cF_red, mpc.F0_red, mpc.cols,
                              iters=8, x0=x0, q0=q0_, lam0=lam0_,
                              band_offset=mpc.band)
        return s.x, s.lam, s.ok

    args = (Jt.permute(3, 0, 1, 2).numpy(), lanes3(cv), T(d["zeta"]),
            T(d["up"]), T(d["sq"]), T(d["x0"]), T(q0), T(lam0))
    axes = tuple(None if a is None else 0 for a in args)
    jx, jlam, jok = (np.asarray(a) for a in jax.jit(
        jax.vmap(lane, in_axes=axes))(*args))
    np.testing.assert_array_equal(sol.ok.numpy(), jok)
    assert jok.all()
    np.testing.assert_allclose(sol.x.numpy().T, jx, rtol=0, atol=1e-9)
    np.testing.assert_allclose(sol.lam.numpy().T, jlam, rtol=0,
                               atol=1e-9 * max(1.0, np.abs(jlam).max()))


@pytest.mark.parametrize("jac", ["fresh", "frozen"])
def test_f64_chord_pass_near_the_jax_route(setup, jac):
    """The JAX controller's ``_stage_lin`` and ``solve_qp_nmpc`` with its
    own operands: the bound is its f32 maps' and constants', see (b)."""
    mpc, qp, jacs, d, _ = setup
    Jt, cv = jacs[jac]
    sol = solve_qp_nmpc_pass(qp, Jt, cv, d["zeta"], d["up"], d["sq"],
                             x0=d["x0"], q0=d["q0"], lam0=d["lam0"], iters=8)
    _, jmpc, _ = jax_bench("nonlinear")
    rdiag = jmpc._RdTj + RHO * jmpc._bsizes
    sq = np.sqrt(jmpc.q_diag)

    def lane(z, u, r, Ul, Zl, Fv, x0, q0, lam0):
        Ul = Ul.reshape(10, 3)
        frozen = None
        if jac == "frozen":
            frozen = jmpc._stage_lin(jnp.tile(z[None], (10, 1)),
                                     jnp.tile(u[None], (10, 1)))[:2]
        jz, ju, c = jmpc._stage_lin(Zl, Ul, frozen=frozen, Fv=Fv)
        s = jax_solve_qp_nmpc(jz, ju, c, z, u, sq, r, jmpc.Cz, rdiag,
                              jmpc._Azj, jmpc._cFzj, jmpc._F0j, jmpc._cols,
                              iters=8, x0=x0, q0=q0, lam0=lam0,
                              band_offset=jmpc._band)
        return s.x, s.ok

    jx, jok = jax.jit(jax.vmap(lane))(
        T(d["zeta"]), T(d["up"]), T(d["sq"]), T(d["U"]), lanes3(d["Z"][:-1]),
        lanes3(d["Z"][1:]), T(d["x0"]), T(d["q0"]), T(d["lam0"]))
    np.testing.assert_array_equal(sol.ok.numpy(), np.asarray(jok))
    dx = np.abs(sol.x.numpy().T - np.asarray(jx)).max()
    print(f"{jac}: max |dx| against the JAX route: {dx:.3e}")
    assert 1e-9 < dx < 1e-4, dx


@pytest.mark.parametrize("jac", ["fresh", "frozen"])
def test_stage_lin_matches_jax(setup, jac):
    _, qp, jacs, d, jmpc64 = setup
    Jt, cv = jacs[jac]

    def lane(Zl, Ul, Fv, Jh):
        frozen = None if jac == "fresh" else _jz_ju(Jh)
        return jmpc64._stage_lin(Zl, Ul.reshape(10, 3), frozen=frozen, Fv=Fv)

    jz, ju, jcv = (np.asarray(a) for a in jax.vmap(lane)(
        lanes3(d["Z"][:-1]), T(d["U"]), lanes3(d["Z"][1:]),
        d["Jh"].permute(3, 0, 1, 2).numpy()))
    np.testing.assert_allclose(Jt[:, :6].permute(3, 0, 2, 1).numpy(), jz,
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(Jt[:, 6:].permute(3, 0, 2, 1).numpy(), ju,
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(lanes3(cv), jcv, rtol=0, atol=1e-12)
    assert Jt.shape == (10, 9, 6, B) and cv.shape == (10, 6, B)


def test_rollout_and_merit_match_jax(setup):
    mpc, _, _, d, jmpc64 = setup
    Z = mpc._rollout_full(d["zeta"], d["U"])
    refs = d["ref"].numpy().T.reshape(B, 11, 2)
    jZ = np.asarray(jax.vmap(jmpc64._rollout_full)(
        T(d["zeta"]), T(d["U"]).reshape(B, 10, 3)))
    np.testing.assert_allclose(lanes3(Z), jZ, rtol=0, atol=1e-12)
    cost = mpc._cost_from_Z(Z, d["U"], d["sq"]).numpy()
    jcost = np.asarray(jax.vmap(jmpc64._cost_from_Z)(
        jZ, T(d["U"]).reshape(B, 10, 3), refs))
    np.testing.assert_allclose(cost, jcost, rtol=1e-12, atol=0)
    np.testing.assert_allclose(
        mpc._roll_cost(d["zeta"], d["U"], d["sq"]).numpy(), jcost,
        rtol=1e-12, atol=0)
    assert Z.shape == (11, 6, B) and torch.equal(Z[0], d["zeta"])


def test_line_search_matches_jax(setup):
    """The halvings between the held plan and the QP plan: the same
    winner in every lane, and its rollout and merit."""
    mpc, _, _, d, jmpc64 = setup
    U, Z, cost = mpc._line_search(d["zeta"], d["Uh"], d["U"], d["sq"])
    jU, jZ, jcost = (np.asarray(a) for a in jax.vmap(jmpc64._line_search)(
        T(d["zeta"]), T(d["Uh"]).reshape(B, 10, 3),
        T(d["U"]).reshape(B, 10, 3), d["ref"].numpy().T.reshape(B, 11, 2)))
    np.testing.assert_allclose(T(U).reshape(B, 10, 3), jU, rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(lanes3(Z), jZ, rtol=0, atol=1e-12)
    np.testing.assert_allclose(cost.numpy(), jcost, rtol=1e-12, atol=0)
    full = (U - d["U"]).abs().amax(0) == 0
    assert 0 < int(full.sum()) < B      # some lanes took a shorter step


def test_stale_condensation_identity(setup):
    """Frozen Jacobians at an unmoved point reproduce the fresh pass
    exactly; at a moved point the frozen affine recursion is the JAX
    ``_condense_stale``'s (v with no reference and no u_prev fold is
    sqrt(Q) Cz s_k)."""
    mpc, qp, jacs, d, jmpc64 = setup
    Jt, cv = jacs["fresh"]
    Zl, Fv = d["Z"][:-1], d["Z"][1:]
    Jt2, cv2 = N.stage_lin(qp, Zl, d["U"], frozen=Jt, Fv=Fv)
    assert Jt2.data_ptr() == Jt.data_ptr() and torch.equal(cv2, cv)
    args = (d["zeta"], d["up"], d["sq"], d["x0"], d["q0"], None, 8, 1e-2)
    for a, b in zip(N.jacobian_pass(qp, Jt, cv, *args),
                    N.jacobian_pass(qp, Jt2, cv2, *args)):
        assert torch.equal(a, b)
    # moved point: Jacobians frozen at the held state, defects at the plan
    Jf, cf = jacs["frozen"]
    zero = torch.zeros_like
    _, v = N.condense(qp, Jf, cf, d["zeta"], zero(d["up"]), zero(d["sq"]))

    def lane(z, Ul, Zl, Fv, Jh):
        jz, ju = _jz_ju(Jh)
        _, sz = jmpc64._condense(Zl, Ul.reshape(10, 3), z,
                                 frozen=(jz, ju, None), Fv=Fv)
        return sz

    sz = np.asarray(jax.vmap(lane)(T(d["zeta"]), T(d["U"]), lanes3(Zl),
                                   lanes3(Fv),
                                   d["Jh"].permute(3, 0, 1, 2).numpy()))
    y = np.einsum("pi,bki->bkp", mpc.Cz, sz[..., :6]).reshape(B, -1)
    np.testing.assert_allclose(v.numpy().T, mpc.sqq * y, rtol=0, atol=1e-12)


def test_chord_dispatch_and_kernel_refuses_cpu(setup):
    """CPU tensors take the plain version (no launch is counted); the
    kernel's wrapper refuses them, as it refuses mis-shaped Jacobians."""
    _, qp, jacs, d, _ = setup
    Jt, cv = jacs["fresh"]
    args = (d["zeta"], d["up"], d["sq"], d["x0"], None, None, 8, 1e-2)
    before = nmpc_pass_cuda.launches
    x = nmpc_pass(qp, Jt, cv, *args)[0]
    assert nmpc_pass_cuda.launches == before and x.shape == (12, B)
    with pytest.raises(ValueError):
        nmpc_pass_cuda(qp, Jt, cv, *args)
    with pytest.raises(ValueError):
        nmpc_pass_cuda(qp, Jt.float()[:-1], cv.float(),
                       *(a.float() if torch.is_tensor(a) else a
                         for a in args))


CHORD_REGIMES = {
    "jac2": dict(sqp_jac_period=2),
    "jac2_dual_warm": dict(sqp_jac_period=2, sqp_dual_warm=True),
    "jac3_best_linesearch": dict(sqp_jac_period=3, sqp_best_of_passes=True,
                                 sqp_linesearch=1),
}


@pytest.mark.parametrize("regime", sorted(CHORD_REGIMES))
def test_chord_regime_solve_matches_jax(regime):
    knobs = CHORD_REGIMES[regime]
    model, scaler, _ = load_model(NONLINEAR_MODEL)
    mpc = NonlinearKmpc(model, scaler, MpcConfig(**NMPC_MPC, **knobs),
                        device="cpu", dtype=torch.float64)
    assert mpc.route == "chord"
    zeta, up, sq = nmpc_lanes(B, 31)
    U, sol = mpc.solve(zeta, up, sq)
    _, jmpc = jax_nmpc(**knobs)
    ref = (sq / torch.from_numpy(mpc.sqq)[:, None]).numpy().T
    jU, jok = jax.jit(jax.vmap(jmpc.solve))(
        T(zeta), T(up), ref.reshape(B, 11, 2))
    np.testing.assert_array_equal(sol.ok.numpy(), np.asarray(jok))
    dU = np.abs(T(U) - np.asarray(jU).reshape(B, 30)).max()
    print(f"{regime}: max |dU| against the JAX controller: {dU:.3e}")
    assert dU < 1e-4, dU
