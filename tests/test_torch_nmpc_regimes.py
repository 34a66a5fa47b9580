"""The port's ``NonlinearKmpc`` in the SQP regimes off the multipass route
against the JAX controller, the routes it takes, and the regime reference
file that ``chip_smoke.py`` holds the card to.

(a) ``NonlinearKmpc.solve`` (f64) per regime against the JAX controller's
    ``solve`` on the same lanes (x64, CPU): the six single knobs and their
    combinations on the stage route (the chord route's are in
    ``test_torch_nmpc_pass.py``).  The JAX controller runs its Jacobian
    generator as a bf16 hi/lo split and its dynamics and constants in
    f32, the port in f64: measured at most 1.8e-6 on the plan; bound
    1e-4, equal ok masks.
(b) The route of every regime, pass by pass, as ``_solve_from`` takes it
    (control/kmpc.py:1352-1624): multipass, or the stage kernel in its
    'hold' / 'roll' / 'ship' modes, or the chord kernel with Jacobians
    fresh every ``sqp_jac_period`` passes; warm duals from the second pass
    on; no Levenberg term where rho is 0.
(c) ``assets/nmpc_regime_refs.json`` (``python tests/test_torch_oracle.py
    --write-regime-refs``): its regimes and configurations are the ones
    ``chip_smoke.py`` runs, each on its route, and the JAX runner kept
    every lane alive in each.  The 'linear' update's regimes are in
    ``test_torch_nmpc_linear.py``.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import jax

from koopman_realizations_tpu.config import MpcConfig as JMpcConfig

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
    NMPC_REGIMES,
    REGIME_REFS,
    jax_nmpc,
    nmpc_lanes,
)

import chip_smoke  # noqa: E402  (the repository root, on the path above)
from test_torch_oracle import one_thread  # noqa: E402,F401  (fixture)

# one torch thread a test process: the xdist workers' pools would
# oversubscribe the machine
pytestmark = pytest.mark.usefixtures("one_thread")

B = 8

STAGE_REGIMES = {
    **{k: v for k, v in NMPC_REGIMES.items()
       if "sqp_jac_period" not in v and "sqp_update" not in v},
    "dual_warm_decay": dict(sqp_dual_warm=True, sqp_damping=0.3,
                            sqp_damping_decay=0.5),
    "rollout_init_dual_warm": dict(sqp_init="rollout", sqp_dual_warm=True),
}


def _controller(**knobs):
    model, scaler, _ = load_model(NONLINEAR_MODEL)
    return NonlinearKmpc(model, scaler, MpcConfig(**NMPC_MPC, **knobs),
                         device="cpu", dtype=torch.float64)


@pytest.fixture(scope="module")
def lanes():
    zeta, up, sq = nmpc_lanes(B, 3)
    rng = np.random.default_rng(8)
    U_plan = torch.from_numpy(rng.uniform(-0.6, 0.6, (30, B)))
    return zeta, up, sq, U_plan


@pytest.mark.parametrize("regime", sorted(STAGE_REGIMES))
def test_regime_solve_matches_jax(lanes, regime):
    zeta, up, sq, U_plan = lanes
    knobs = STAGE_REGIMES[regime]
    mpc = _controller(**knobs)
    U, sol = mpc.solve(zeta, up, sq, U_plan)
    _, jmpc = jax_nmpc(**knobs)
    T = lambda t: t.numpy().T
    ref = T(sq / torch.from_numpy(mpc.sqq)[:, None]).reshape(B, 11, 2)
    jU, jok = jax.jit(jax.vmap(jmpc.solve))(
        T(zeta), T(up), ref, T(U_plan).reshape(B, 10, 3))
    np.testing.assert_array_equal(sol.ok.numpy(), np.asarray(jok))
    dU = np.abs(T(U) - np.asarray(jU).reshape(B, 30)).max()
    print(f"{regime} ({mpc.route}): max |dU| against the JAX controller: "
          f"{dU:.3e}")
    assert dU < 1e-4, dU


# expected per-step call sequences: ("multipass",), ("stage", mode, warm
# duals, Levenberg term), ("lin", fresh Jacobians), ("pass", warm, term)
H, R, S = (("stage", m) for m in ("hold", "roll", "ship"))
ROUTES = {
    "default": ({}, [("multipass",)]),
    "dual_warm": (dict(sqp_dual_warm=True),
                  [H + (False, True)] + [R + (True, True)] * 4),
    "rollout_init_dual_warm": (dict(sqp_init="rollout", sqp_dual_warm=True),
                               [R + (False, True)] + [R + (True, True)] * 4),
    "damping_decay": (dict(sqp_damping=0.3, sqp_damping_decay=0.5),
                      [H + (False, True)] + [R + (False, True)] * 4),
    "no_damping_decay": (dict(sqp_damping=0.0, sqp_damping_decay=0.5),
                         [H + (False, False)] + [R + (False, False)] * 4),
    "linesearch": (dict(sqp_linesearch=2), [S + (False, True)] * 5),
    "best_of_passes": (dict(sqp_best_of_passes=True),
                       [S + (False, True)] * 5),
    "multistart": (dict(sqp_multistart=True),
                   [("multipass",), S + (False, True)]
                   + [R + (False, True)] * 4),
    "multistart_dual_warm": (
        dict(sqp_multistart=True, sqp_dual_warm=True),
        [H + (False, True)] + [R + (True, True)] * 4
        + [S + (False, True)] + [R + (True, True)] * 4),
    "jac_period2": (dict(sqp_jac_period=2),
                    [("lin", f) + ("pass", False, True)
                     for f in (True, False, True, False, True)]),
    "jac_period3_best": (dict(sqp_jac_period=3, sqp_best_of_passes=True),
                         [("lin", f) + ("pass", False, True)
                          for f in (True, False, False, True, False)]),
    "one_pass_dual_warm": (dict(sqp_iters=1, sqp_dual_warm=True),
                           [H + (False, True)]),
}


@pytest.mark.parametrize("name", sorted(ROUTES))
def test_route_follows_solve_from(lanes, monkeypatch, name):
    zeta, up, sq, U_plan = lanes
    knobs, expected = ROUTES[name]
    log = []

    def spy(kind, fn):
        def call(*a, **kw):
            if kind == "multipass":
                log.append(("multipass",))
            elif kind == "lin":
                log.append(("lin", kw.get("frozen") is None))
            elif kind == "stage":
                log.append(("stage", a[1], kw["lam0"] is not None,
                            kw["q0"] is not None))
            else:
                log[-1] += ("pass", kw["lam0"] is not None,
                            kw["q0"] is not None)
            return fn(*a, **kw)
        return call

    for kind, attr in (("multipass", "solve_qp_nmpc_multipass"),
                       ("lin", "stage_lin"),
                       ("stage", "solve_qp_nmpc_stages"),
                       ("pass", "solve_qp_nmpc_pass")):
        monkeypatch.setattr(K, attr, spy(kind, getattr(K, attr)))
    mpc = _controller(**knobs)
    U, sol = mpc.solve(zeta[:, :2], up[:, :2], sq[:, :2], U_plan[:, :2])
    assert log == expected
    assert mpc.route == {"multipass": "multipass", "stage": "stage",
                         "lin": "chord"}[expected[0][0]]
    assert U.shape == (30, 2) and torch.isfinite(U).all()
    assert sol.x.shape == (12, 2) and sol.ok.shape == (2,)


def test_multistart_keeps_the_better_plan(lanes):
    """With a previous plan the multistart's answer is, lane by lane, the
    one of lower true merit of the cold SQP and the SQP from the shifted
    plan; without one it is the cold SQP."""
    zeta, up, sq, U_plan = lanes
    ms, cold = _controller(sqp_multistart=True), _controller()
    U, sol = ms.solve(zeta, up, sq, U_plan)
    U1, _ = cold.solve(zeta, up, sq)
    torch.testing.assert_close(ms.solve(zeta, up, sq)[0], U1, rtol=0, atol=0)
    c, c1 = ms._roll_cost(zeta, U, sq), ms._roll_cost(zeta, U1, sq)
    assert sol.ok.all() and bool((c <= c1).all())
    assert bool((U != U1).any(0).any())       # some lane took the warm SQP


def _json(value):
    return json.loads(json.dumps(value))


def test_regime_refs_match_the_configs_chip_smoke_runs():
    refs = json.loads(REGIME_REFS.read_text())
    assert (refs["B"], refs["steps"]) == (16, 301)
    configs = chip_smoke.regime_configs()
    assert sorted(refs["regimes"]) == sorted(NMPC_REGIMES) == sorted(configs)
    for name, entry in refs["regimes"].items():
        knobs = NMPC_REGIMES[name]
        assert entry["knobs"] == _json(knobs)
        assert entry["config"] == _json(dataclasses.asdict(
            JMpcConfig(**NMPC_MPC, **knobs)))
        assert MpcConfig(**configs[name]) == MpcConfig(**NMPC_MPC, **knobs)
        assert entry["alive"] == 1.0 and 0.02 < entry["err_mean"] < 0.03
        route = _controller(**knobs).route
        assert route == ("chord" if "sqp_jac_period" in knobs else
                         "linear" if "sqp_update" in knobs else
                         "multipass" if knobs == dict(sqp_multistart=True)
                         else "stage")
    for name in chip_smoke.FULL_REGIMES:
        assert refs["regimes"][name]["alive"] == 1.0
    assert [_controller(**NMPC_REGIMES[n]).route
            for n in chip_smoke.FULL_REGIMES] == ["stage", "chord"]


def test_nmpc_device_operands_require_a_device():
    """The device-operand functions take no default device."""
    mpc = _controller()
    with pytest.raises(TypeError):
        N.nmpc_qp_operands(mpc.A1, mpc.A2, mpc.a0, mpc.G, (), mpc.Cz,
                           mpc.sqq, mpc.cols, mpc.rdiag, mpc.q0c, mpc.Gup,
                           mpc.F_red, mpc.cF_red, mpc.F0_red, mpc.band)
    from koopman_realizations_torch.ops.qp import lift_qp_operands
    with pytest.raises(TypeError):
        lift_qp_operands({}, (), mpc.RdT, mpc.F_red, mpc.cF_red,
                         mpc.F0_red, mpc.band)
