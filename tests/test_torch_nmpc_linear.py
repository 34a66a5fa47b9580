"""The port's SQP NMPC with the infeasible-path 'linear' between-pass
update (``sqp_update='linear'``) against the JAX package.

(a) The linearized dynamics' state sequence that the update moves the
    trajectory along (``ops/nmpc.py:linear_rollout``) against the JAX
    controller's explicit condensation with the full nz-row stack
    (``_condense_inner`` with keep = nz; (sz + Sz Uvec)[:-1],
    control/kmpc.py:1599-1612), fresh and with Jacobians frozen at another
    point (``_condense_stale``), in f64 with the model's W in f64: 1e-10.
(b) ``NonlinearKmpc.solve`` on the 'linear' route (f64) against the JAX
    controller on the same lanes, alone and with the knobs it combines
    with (best-of-passes, chord Jacobians, decaying damping with warm
    duals, the line search, multistart, the rollout init): the JAX
    controller pins its constraint stack and constants to f32 and runs
    its Jacobian generator as a bf16 hi/lo split, the port runs f64:
    measured at most 2.2e-6 on the plan; bound 1e-4, as for the other
    regimes (``test_torch_nmpc_regimes.py``), equal ok masks.
(c) The route pass by pass: fresh stage Jacobians (frozen between
    ``sqp_jac_period`` refreshes), the explicit condensation and one
    ``solve_qp_factored`` with q0 (none at rho = 0) and the previous
    pass's multipliers under ``sqp_dual_warm``; the nonlinear rollout only
    for best-of-passes' merit; no NMPC kernel.  The unblocked stack stays
    refused.

The B=16 x 301 closed loops of both regimes against the JAX references
are in ``test_torch_nmpc_linear_loop.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from koopman_realizations_tpu.config import MpcConfig as JMpcConfig
from koopman_realizations_tpu.control import make_kmpc

from koopman_realizations_torch.config import MpcConfig
from koopman_realizations_torch.control import kmpc as K
from koopman_realizations_torch.control.kmpc import NonlinearKmpc
from koopman_realizations_torch.ops import nmpc as N
from koopman_realizations_torch.utils.checkpoint import (
    NONLINEAR_MODEL,
    load_model,
)

from test_torch_oracle import (
    NMPC_MPC,
    jax_model,
    jax_nmpc,
    nmpc_lanes,
    one_thread,  # noqa: F401  (the fixture of pytestmark)
)

pytestmark = pytest.mark.usefixtures("one_thread")

B = 8
LIN = dict(sqp_update="linear")


def _controller(**knobs):
    model, scaler, _ = load_model(NONLINEAR_MODEL)
    return NonlinearKmpc(model, scaler, MpcConfig(**NMPC_MPC, **knobs),
                         device="cpu", dtype=torch.float64)


@pytest.fixture(scope="module")
def lanes():
    zeta, up, sq = nmpc_lanes(B, 11)
    rng = np.random.default_rng(12)
    U_plan = torch.from_numpy(rng.uniform(-0.6, 0.6, (30, B)))
    return zeta, up, sq, U_plan


T = lambda t: t.numpy().T
lanes3 = lambda t: t.permute(2, 0, 1).numpy()          # (.., .., B) -> B first


@pytest.mark.parametrize("frozen", [False, True])
def test_linear_rollout_matches_jax_full_condensation(lanes, frozen):
    zeta, up, sq, _ = lanes
    mpc = _controller(**LIN)
    U, _ = mpc.solve(zeta, up, sq)
    qp = mpc.nmpc_qp()
    Z = N.rollout(qp, zeta, U)
    Zh, Uh = zeta.expand((10,) + zeta.shape), up.repeat(10, 1)
    Jh = N.stage_lin(qp, Zh, Uh)[0]
    Jt, cv = N.stage_lin(qp, Z[:-1], U, frozen=Jh if frozen else None,
                         Fv=Z[1:])
    # a plan off the blocked structure, so that Uvec = [U_0; Sel U[1:]]
    # and not U's own stages enter the dynamics
    Un = U + torch.from_numpy(np.random.default_rng(3).normal(
        0, 0.05, U.shape))
    mine = N.linear_rollout(qp, Jt, cv, zeta, Un, mpc.Sel_t)
    jm, jscaler = jax_model("nonlinear")
    jm64 = dataclasses.replace(jm, W=jnp.asarray(np.asarray(jm.W,
                                                            np.float64)))
    jmpc = make_kmpc(jm64, jscaler, JMpcConfig(**NMPC_MPC, **LIN))
    assert jmpc._full_S
    Sel = np.asarray(mpc.Sel)

    def lane(z, u, Ul, Zl, Fv, Uvn):
        if frozen:
            # the refresh pass at the held point, then the stale one
            Sh, _, jacs = jmpc._condense_inner(
                jnp.tile(z[None], (10, 1)), jnp.tile(u[None], (10, 1)), z)
            Sz, sz = jmpc._condense(Zl, Ul.reshape(10, 3), z,
                                    frozen=(*jacs, Sh), Fv=Fv)
        else:
            Sz, sz, _ = jmpc._condense_inner(Zl, Ul.reshape(10, 3), z,
                                             Fv=Fv)
        Uvec = jnp.concatenate([Uvn[:3], Sel @ Uvn[3:]])
        return (sz + Sz @ Uvec)[:-1]

    ref = np.asarray(jax.vmap(lane)(T(zeta), T(up), T(U), lanes3(Z[:-1]),
                                    lanes3(Z[1:]), T(Un)))
    np.testing.assert_allclose(lanes3(mine), ref, rtol=0, atol=1e-10)
    assert torch.equal(mine[0], zeta)


SOLVES = {
    "linear_update": {},
    "linear_update_best": dict(sqp_best_of_passes=True),
    "jac_period": dict(sqp_jac_period=2),
    "dual_warm_decay": dict(sqp_dual_warm=True, sqp_damping=0.3,
                            sqp_damping_decay=0.5),
    "linesearch": dict(sqp_linesearch=2),
    "multistart": dict(sqp_multistart=True),
    "rollout_init": dict(sqp_init="rollout"),
}


@pytest.mark.parametrize("name", sorted(SOLVES))
def test_linear_solve_matches_jax(lanes, name):
    zeta, up, sq, U_plan = lanes
    knobs = {**LIN, **SOLVES[name]}
    mpc = _controller(**knobs)
    assert mpc.route == "linear"
    U, sol = mpc.solve(zeta, up, sq, U_plan)
    _, jmpc = jax_nmpc(**knobs)
    ref = T(sq / torch.from_numpy(mpc.sqq)[:, None]).reshape(B, 11, 2)
    jU, jok = jax.jit(jax.vmap(jmpc.solve))(
        T(zeta), T(up), ref, T(U_plan).reshape(B, 10, 3))
    np.testing.assert_array_equal(sol.ok.numpy(), np.asarray(jok))
    dU = np.abs(T(U) - np.asarray(jU).reshape(B, 30)).max()
    print(f"{name}: max |dU| against the JAX controller: {dU:.3e}")
    assert dU < 1e-4, dU


# expected per-step call sequences: ("lin", fresh Jacobians) then
# ("factored", warm duals, q0) per pass; ("roll",) for each nonlinear
# rollout
ROUTES = {
    "linear_update": ({}, [("lin", True), ("factored", False, True)] * 5),
    "linear_update_best": (
        dict(sqp_best_of_passes=True),
        [("lin", True), ("factored", False, True), ("roll",)] * 5),
    "jac_period3_dual_warm": (
        dict(sqp_jac_period=3, sqp_dual_warm=True),
        [("lin", True), ("factored", False, True)]
        + [("lin", False), ("factored", True, True)] * 2
        + [("lin", True), ("factored", True, True)]
        + [("lin", False), ("factored", True, True)]),
    "no_damping": (dict(sqp_damping=0.0),
                   [("lin", True), ("factored", False, False)] * 5),
}


@pytest.mark.parametrize("name", sorted(ROUTES))
def test_linear_route_follows_solve_from(lanes, monkeypatch, name):
    zeta, up, sq, _ = lanes
    knobs, expected = ROUTES[name]
    log = []

    def spy(kind, fn):
        def call(*a, **kw):
            if kind == "lin":
                log.append(("lin", kw.get("frozen") is None))
            elif kind == "factored":
                log.append(("factored", kw["lam0"] is not None,
                            kw["q0"] is not None))
            elif kind == "roll":
                log.append(("roll",))
            else:
                raise AssertionError(f"{kind} on the 'linear' route")
            return fn(*a, **kw)
        return call

    for kind, attr in (("lin", "stage_lin"),
                       ("factored", "solve_qp_factored"),
                       ("roll", "rollout"),
                       ("multipass", "solve_qp_nmpc_multipass"),
                       ("stage", "solve_qp_nmpc_stages"),
                       ("pass", "solve_qp_nmpc_pass")):
        monkeypatch.setattr(K, attr, spy(kind, getattr(K, attr)))
    mpc = _controller(**LIN, **knobs)
    U, sol = mpc.solve(zeta[:, :2], up[:, :2], sq[:, :2])
    assert log == expected
    assert U.shape == (30, 2) and torch.isfinite(U).all()
    assert sol.x.shape == (12, 2) and sol.ok.all()


def test_linear_update_refuses_the_unblocked_stack():
    """The 'linear' update on the unblocked stack constructs: its QP is
    ``ipm_factored``'s q0 build at n=27, mc=108 (the solve and loop are
    held to JAX in ``test_torch_nmpc_unblocked.py``)."""
    model, scaler, _ = load_model(NONLINEAR_MODEL)
    mpc = NonlinearKmpc(model, scaler,
                        MpcConfig(**{**NMPC_MPC, **LIN, "input_blocks": None}),
                        device="cpu")
    qp = mpc.nmpc_qp()
    assert mpc.route == "linear" and (qp.n, qp.mc) == (27, 108)
