"""The port's SQP NMPC on the unblocked stack -- the default
``input_blocks=None`` and the reference's own NMPC (``Kmpc.m:1114-1181``):
every input of stages 1..Np-1 a decision, n = (Np-1) m = 27, mc = 108 --
in each route the JAX controller takes there, against the JAX package
(``assets/nmpc_unblocked_refs.json``, ``python tests/test_torch_oracle.py
--write-unblocked-refs``: the JAX controller's solve on four lanes and
its general runner at B=16 x 301, x64 and with x64 off).

Tolerances, each with what it was measured at:
- ``NonlinearKmpc.solve`` (f64) of each route against the JAX
  controller's (x64) on the same lanes: the plans within 1e-4, equal ok
  masks (the JAX controller keeps its Jacobian generator as a bf16 hi/lo
  pair and its dynamics and constants in f32, the port in f64; ROADMAP
  §3 parity note 1);
- the whole SQP of the multipass route against an oracle composed from
  the exact JAX pieces (f64, ``test_torch_nmpc_multipass._oracle``): 1e-9
  on x and the multipliers;
- the state-bound pass's QP solved by the JAX ``solve_qp(shared_A=False)``
  on the port's own f64 operands against ``ops/qp.py:solve_qp_lane_A``:
  1e-9;
- the general runner (f64, B=16 x 301) on the default configuration:
  err_mean within 1e-5 of JAX x64, alive equal; the f32 plain path within
  1e-3 (``test_torch_nmpc_unblocked_f32.py``).
"""

import json
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from koopman_realizations_tpu.ops.qp import solve_qp as jax_solve_qp

from koopman_realizations_torch.config import ArmConfig, MpcConfig
from koopman_realizations_torch.control.kmpc import NonlinearKmpc
from koopman_realizations_torch.control.ksim import Ksim
from koopman_realizations_torch.models.arm import Arm
from koopman_realizations_torch.ops import nmpc as N
from koopman_realizations_torch.ops.kernels.nmpc_multipass import (
    solve_qp_nmpc_multipass,
)
from koopman_realizations_torch.ops.qp import solve_qp_lane_A
from koopman_realizations_torch.utils.checkpoint import (
    NONLINEAR_MODEL,
    load_model,
)
from koopman_realizations_torch.utils.metrics import lane_tracking_error
from koopman_realizations_torch.utils.trajectories import blockM_reference

from test_torch_nmpc_multipass import _jax_model64, _oracle
from test_torch_oracle import (
    BENCH_ARM,
    REF_B,
    REF_STEPS,
    UNBLOCKED_NMPC,
    UNBLOCKED_PATHS,
    UNBLOCKED_REFS,
    UNBLOCKED_SOLVE_B,
    UNBLOCKED_STEPS,
    bench_X0,
    dict_asset_path,
    jax_model,
    nmpc_lanes,
    one_thread,  # noqa: F401  (the fixture of pytestmark)
    unblocked_plan,
)

pytestmark = pytest.mark.usefixtures("one_thread")

B = UNBLOCKED_SOLVE_B
# each path's route (NonlinearKmpc.route) on the unblocked stack
ROUTES = {"default": "multipass", "damping_decay": "stage",
          "linesearch": "stage", "jac_period": "chord",
          "linear_update": "linear", "state_bounds": "state_bounds",
          "jacfwd": "jacfwd"}


def refs():
    return json.loads(UNBLOCKED_REFS.read_text())


def controller(name, dtype=torch.float64):
    asset, knobs = UNBLOCKED_PATHS[name]
    path = dict_asset_path(asset) if asset == "nmpc-fs1" \
        else NONLINEAR_MODEL
    model, scaler, _ = load_model(path)
    return NonlinearKmpc(model, scaler,
                         MpcConfig(**{**UNBLOCKED_NMPC, **knobs}),
                         device="cpu", dtype=dtype)


@pytest.fixture(scope="module")
def lanes():
    zeta, up, sq = nmpc_lanes(B, 3)
    return zeta, up, sq, torch.from_numpy(unblocked_plan(B))


def test_refs_cover_every_route():
    r = refs()
    assert set(r["paths"]) == set(UNBLOCKED_PATHS) == set(ROUTES)
    assert (r["B"], r["steps"]) == (REF_B, REF_STEPS)
    for name, p in r["paths"].items():
        assert p["config"]["input_blocks"] is None, name
        assert all(p["alive"]), name
    # the capped state bound is reached in the JAX loop, whose depth is
    # cut (its plain per-lane interior point is launch-bound on the card)
    sb = r["paths"]["state_bounds"]
    assert sb["outputs_at_bound_lane_steps"] > 0
    assert sb["steps"] == UNBLOCKED_STEPS["state_bounds"] == 101
    assert len(r["paths"]["jacfwd"]["f32_copies"]) == 96


@pytest.mark.parametrize("name", sorted(UNBLOCKED_PATHS))
def test_unblocked_solve_matches_jax(lanes, name):
    zeta, up, sq, U_plan = lanes
    mpc = controller(name)
    assert mpc.route == ROUTES[name] and not mpc.blocked
    qp = mpc.nmpc_qp()
    assert (qp.n, qp.mc) == (27, 108) and qp.cols == tuple(range(0, 30, 3))
    U, sol = mpc.solve(zeta, up, sq, U_plan)
    jr = refs()["paths"][name]["solve"]
    np.testing.assert_array_equal(sol.ok.numpy(), jr["ok"])
    dU = np.abs(U.numpy().T - np.asarray(jr["U"])).max()
    print(f"{name} ({mpc.route}): max |dU| against the JAX controller: "
          f"{dU:.3e}")
    assert dU < 1e-4, dU


def test_unblocked_multipass_matches_composed_jax_oracle(lanes):
    zeta, up, sq, _ = lanes
    mpc = controller("default")
    sol = solve_qp_nmpc_multipass(mpc.nmpc_qp(), zeta, up, sq, 5,
                                  mpc.hold0, 8)
    jm = _jax_model64(SimpleNamespace(model=jax_model("nonlinear")[0]))
    jx, jlam, jok = _oracle(mpc, jm, zeta, up, sq, 5, mpc.hold0, 8)
    np.testing.assert_array_equal(sol.ok.numpy(), jok)
    assert jok.all()
    dx = np.abs(sol.x.numpy().T - jx).max()
    print(f"unblocked multipass: max |dx| against the JAX oracle {dx:.3e}")
    np.testing.assert_allclose(sol.x.numpy().T, jx, rtol=0, atol=1e-9)
    np.testing.assert_allclose(sol.lam.numpy().T, jlam, rtol=0,
                               atol=1e-9 * max(1.0, np.abs(jlam).max()))


def test_state_bound_qp_solves_as_jax(lanes):
    """One state-bound pass: the port's operands (``ops/nmpc.py:
    state_bound_qp``) and ``solve_qp_lane_A`` against the JAX
    ``solve_qp(shared_A=False)`` on the same operands, and the rows' count
    and layout: the input rows, then [-S_k; S_k] of stages 2..Np."""
    zeta, up, sq, U_plan = lanes
    mpc = controller("state_bounds")
    qp = mpc.nmpc_qp()
    Ul = up.repeat(mpc.Np, 1)
    Zl = zeta.expand((mpc.Np,) + zeta.shape)
    Jt, cv = mpc.stage_lin(Zl, Ul)
    q0 = -2.0 * mpc.cfg.sqp_damping * Ul[3:]
    P, f, A, b = N.state_bound_qp(qp, Jt, cv, zeta, up, sq, q0, mpc.sb_lo_t,
                                  mpc.sb_hi_t, mpc.F_t, mpc.cF_t)
    assert A.shape == (108 + 2 * 6 * 9, 27, B) and b.shape == (216, B)
    # the state rows of stage k are minus and plus the same sensitivities
    np.testing.assert_array_equal(A[108:114].numpy(), -A[114:120].numpy())
    sol = solve_qp_lane_A(P, f, A, b, iters=8, x0=Ul[3:])
    T = lambda t, *d: t.permute(*d).numpy()
    jsol = jax.jit(jax.vmap(
        lambda P_, f_, A_, b_, x_: jax_solve_qp(P_, f_, A_, b_, iters=8,
                                                x0=x_, shared_A=False,
                                                backend="jax")))(
        T(P, 2, 0, 1), T(f, 1, 0), T(A, 2, 0, 1), T(b, 1, 0),
        T(Ul[3:], 1, 0))
    np.testing.assert_array_equal(sol.ok.numpy(), np.asarray(jsol.ok))
    dx = np.abs(sol.x.numpy().T - np.asarray(jsol.x)).max()
    print(f"state-bound QP: max |dx| against JAX solve_qp {dx:.3e}")
    assert dx < 1e-9, dx


def loop(name, dtype):
    mpc = controller(name, dtype)
    sim = Ksim(Arm(ArmConfig(**BENCH_ARM), device="cpu"), mpc, device="cpu")
    out = sim.batched_runner(blockM_reference(), steps=REF_STEPS)(
        bench_X0(REF_B), np.zeros((REF_B, 2), np.float32))
    err = lane_tracking_error(out["Yp"], blockM_reference()).numpy()
    return err, out["alive"][:, -1].numpy()


def check_loop(dtype, bound):
    """The default configuration's general runner at B=16 x 301: alive as
    JAX x64's and err_mean within ``bound`` of it."""
    jr = refs()["paths"]["default"]
    err, alive = loop("default", dtype)
    print(f"unblocked NMPC {dtype}: err_mean {err.mean():.9f} (JAX x64 "
          f"{np.mean(jr['err_mean']):.9f}; JAX f32 "
          f"{np.mean([e for _, e in jr['f32']]):.9f}), alive {alive.mean()}")
    np.testing.assert_array_equal(alive, jr["alive"])
    assert abs(err.mean() - np.mean(jr["err_mean"])) < bound


def test_unblocked_loop_matches_jax_reference():
    check_loop(torch.float64, 1e-5)
