"""The port's NMPC closed loop as a whole against the JAX general runner:
the SQP controller (qp_iters=8, sqp_iters=5, cold duals) on the committed
nonlinear asset, the bench plant, the blockM reference.

- The f64 general runner's records against a live JAX general run on the
  first 4 lanes over 30 steps.  The JAX controller runs its Jacobian
  generator as a bf16 hi/lo split and its dynamics and QP constants in
  f32 even in an x64 session, the port in f64 throughout: measured
  max |dYp| 2.5e-5; bound 1e-4.  Equal alive masks.
- B=16 over the full 301 steps against the asset header's JAX general
  runner (x64, the same 16 lanes): the port's general runner in f64 to
  1e-5 on err_mean (measured 7.5e-9: the split's error does not build up
  in this loop), its f32 plain path to 1e-3 (measured 2.8e-5;
  ``test_torch_nmpc_closed_loop_f32.py``, a file of its own so that the
  two ~100 s loops run on different test workers); both keep every lane
  alive.
- The NMPC has no fused step, as in the JAX package.
"""

import numpy as np
import pytest
import torch

from koopman_realizations_torch.config import ArmConfig, MpcConfig
from koopman_realizations_torch.control.kmpc import NonlinearKmpc
from koopman_realizations_torch.control.ksim import Ksim
from koopman_realizations_torch.models.arm import Arm
from koopman_realizations_torch.utils.checkpoint import (
    NONLINEAR_MODEL,
    load_model,
)
from koopman_realizations_torch.utils.metrics import lane_tracking_error
from koopman_realizations_torch.utils.trajectories import blockM_reference

from test_torch_oracle import (
    BENCH_ARM,
    NMPC_MPC,
    REF_B,
    REF_STEPS,
    bench_X0,
    jax_general_run,
)
from test_torch_oracle import one_thread  # noqa: E402,F401  (fixture)

# one torch thread a test process: the xdist workers' pools would
# oversubscribe the machine
pytestmark = pytest.mark.usefixtures("one_thread")


def _sim(dtype):
    model, scaler, _ = load_model(NONLINEAR_MODEL)
    mpc = NonlinearKmpc(model, scaler, MpcConfig(**NMPC_MPC), device="cpu",
                        dtype=dtype)
    return Ksim(Arm(ArmConfig(**BENCH_ARM), device="cpu"), mpc,
                device="cpu")


def check_against_header(dtype, bound):
    """The general runner at B=16 over 301 steps: every lane alive and
    err_mean within ``bound`` of the asset header's JAX value."""
    sim = _sim(dtype)
    header = load_model(NONLINEAR_MODEL)[2]["jax_reference"]
    assert (header["B"], header["steps"]) == (REF_B, REF_STEPS)
    out = sim.batched_runner(blockM_reference(), steps=REF_STEPS)(
        bench_X0(REF_B), np.zeros((REF_B, 2), np.float32))
    assert out["Yp"].shape == (REF_B, REF_STEPS - 1, 2)
    assert out["alive"].all() and header["alive"] == 1.0
    err = lane_tracking_error(out["Yp"], blockM_reference()).numpy()
    assert abs(err.mean() - header["err_mean"]) < bound, \
        (err.mean(), header["err_mean"])


def test_nmpc_closed_loop_matches_jax_reference():
    check_against_header(torch.float64, 1e-5)


def test_nmpc_general_runner_records_match_live_jax():
    steps = 30
    jYp, jalive = jax_general_run(4, steps, "nonlinear")
    out = _sim(torch.float64).batched_runner(blockM_reference(), steps=steps)(
        bench_X0(4), np.zeros((4, 2), np.float32))
    np.testing.assert_array_equal(out["alive"].numpy(), jalive)
    np.testing.assert_allclose(out["Yp"].numpy(), jYp, rtol=0, atol=1e-4)


def test_nmpc_has_no_fused_step():
    sim = _sim(torch.float32)
    assert not sim.fused_step_eligible()
    with pytest.raises(ValueError):
        sim.fused_runner(blockM_reference(), steps=5)
    assert not sim._dual_warm


@pytest.mark.parametrize("extra", [
    dict(sqp_update="linear", input_blocks=None),
    dict(state_bounds=(-1.0, 1.0)), dict(input_blocks=None),
    dict(input_blocks=None, state_bounds=(-1.0, 1.0)), dict(sqp_iters=0)])
def test_nmpc_refuses_unported_regimes(extra):
    """The unblocked stack (n = (Np-1) m = 27) constructs on its route:
    multipass by default, 'linear' with the infeasible-path update, and
    with state bounds the per-lane QP route; state bounds under move
    blocking raise, as the JAX base refuses them (kmpc.py:334-338), and
    so does no SQP pass (the SQP knobs off the multipass route construct:
    ``test_torch_nmpc_regimes.py``, ``test_torch_nmpc_linear.py``,
    ``test_torch_nmpc_unblocked.py``; the dual shift is accepted and acts
    on nothing, as in the JAX package: the NMPC carries no duals across
    steps)."""
    model, scaler, _ = load_model(NONLINEAR_MODEL)
    cfg = MpcConfig(**{**NMPC_MPC, **extra})
    if "sqp_iters" in extra or "input_blocks" not in extra:
        with pytest.raises(NotImplementedError):
            NonlinearKmpc(model, scaler, cfg, device="cpu")
        return
    mpc = NonlinearKmpc(model, scaler, cfg, device="cpu")
    route = "state_bounds" if "state_bounds" in extra else \
        "linear" if "sqp_update" in extra else "multipass"
    assert mpc.route == route and not mpc.blocked
    assert mpc.nmpc_qp().n == 27 and mpc.cols == tuple(range(0, 30, 3))


def test_nmpc_refuses_other_models_and_loads():
    """A bilinear model under mpc_type='nonlinear' is the bilinear-as-NMPC
    controller (ported: the jacfwd route, tests/test_torch_nmpc_jacfwd.py),
    which a bilinear controller refuses; a loaded model raises (as in
    JAX)."""
    import dataclasses

    from koopman_realizations_torch.control.kmpc import BilinearKmpc
    bmodel, bscaler, _ = load_model()
    nl = dict(NMPC_MPC, mpc_type="nonlinear")
    assert NonlinearKmpc(bmodel, bscaler, MpcConfig(**nl),
                         device="cpu").route == "jacfwd"
    with pytest.raises(NotImplementedError):
        BilinearKmpc(bmodel, bscaler, MpcConfig(**nl), device="cpu")
    model, scaler, _ = load_model(NONLINEAR_MODEL)
    loaded = dataclasses.replace(
        model, meta=dataclasses.replace(model.meta, nw=2))
    with pytest.raises(NotImplementedError):
        NonlinearKmpc(loaded, scaler, MpcConfig(**NMPC_MPC), device="cpu")
