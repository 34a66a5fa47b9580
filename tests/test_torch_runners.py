"""The closed-loop harness of the port (``control/ksim.py``) against the
JAX ``Ksim`` on the same inputs, f64 on the CPU: ``run_trial_mpc`` and
its results struct (JAX ``_package``, ksim.py:329-359), the timed runner,
``run_batch``, ``run_multi_ref``, ``run_model_simulation``, the
``record`` subsets of ``batched_runner`` and per-step loads with a loaded
model and its observer; and ``utils/timing.py``.

The JAX bilinear controller holds its assembly generators in f32 (parity
note 1 of ROADMAP.md §3), the port in f64: the loops part by ~1e-7, so
the struct's arrays are held to 1e-5, as the general runners' loops are,
and so is the linear controller's.  The JAX NMPC also pins its
constraint stack and blocking to f32 and takes its Jacobian generator as
a bf16 hi/lo pair (same note): its applied inputs part from the port's by
up to 5.3e-5 (measured), so its arrays are held to 1e-4 and the tracking
error, as every struct's, to 1e-5.  Loops are short (B <= 4, <= 30
steps) and each JAX program compiles once per process.
"""

import functools

import numpy as np
import pytest
import torch

import jax

from koopman_realizations_tpu.control.ksim import (
    run_model_simulation as jax_run_model_simulation,
)

from koopman_realizations_torch.config import ArmConfig, MpcConfig
from koopman_realizations_torch.control.kmpc import make_kmpc
from koopman_realizations_torch.control.ksim import (
    RECORD_ALL,
    Ksim,
    run_model_simulation,
)
from koopman_realizations_torch.control.observer import make_load_observer
from koopman_realizations_torch.models.arm import Arm
from koopman_realizations_torch.utils.checkpoint import (
    LINEAR_MODEL,
    LOADED_LINEAR_MODEL,
    NONLINEAR_MODEL,
    load_model,
)
from koopman_realizations_torch.utils.timing import (
    phase_breakdown,
    profile_trace,
    step_time,
)
from koopman_realizations_torch.utils.trajectories import (
    blockM_reference,
    circle_reference,
)

from test_torch_oracle import (
    BENCH_ARM,
    LOADED,
    MODELS,
    bench_X0,
    blockM_y,
    circle_y,
    jax_bench,
    jax_loaded_sim,
    loaded_lanes,
    one_thread,  # noqa: F401  (the fixture of pytestmark)
)

pytestmark = pytest.mark.usefixtures("one_thread")

PATHS = {"bilinear": None, "linear": LINEAR_MODEL,
         "nonlinear": NONLINEAR_MODEL}
KINDS = tuple(PATHS)
# a trial's start: the first joint off the rest, a small previous input
X0 = np.array([0.1, -0.05, 0.0, 0.0, 0.0, 0.0])
U0 = np.array([0.05, -0.02, 0.01])


@functools.lru_cache(maxsize=None)
def port_sim(kind):
    model, scaler, _ = load_model(PATHS[kind]) if PATHS[kind] else \
        load_model()
    mpc = make_kmpc(model, scaler, MpcConfig(**MODELS[kind][1]),
                    device="cpu", dtype=torch.float64)
    return Ksim(Arm(ArmConfig(**BENCH_ARM), device="cpu"), mpc,
                device="cpu")


@functools.lru_cache(maxsize=None)
def jax_trial(kind, steps):
    sim, _, _ = jax_bench(kind)
    return sim.run_trial_mpc(blockM_y(), x0=X0, u0=U0, steps=steps)


def _hold(mine: dict, ref: dict, atol: float = 1e-5):
    """Same keys and shapes; err within 1e-5, every other array but
    comp_time within ``atol``."""
    assert set(mine) == set(ref)
    for k in ref:
        a, b = np.asarray(mine[k]), np.asarray(ref[k])
        assert a.shape == b.shape, k
        if k != "comp_time":
            np.testing.assert_allclose(a.astype(float), b.astype(float),
                                       rtol=0,
                                       atol=1e-5 if k == "err" else atol,
                                       err_msg=k)


ATOL = {"bilinear": 1e-5, "linear": 1e-5, "nonlinear": 1e-4}


STEPS = {"bilinear": 30, "linear": 30, "nonlinear": 12}


@pytest.mark.parametrize("kind", KINDS)
def test_run_trial_mpc_matches_jax(kind):
    """The results struct of one trial from x0 with u0 seeding the input
    window and the plan: keys and shapes as JAX's, the arrays (U, Y, R, X,
    Z -- zeta for the lift-fused bilinear controller and the NMPC, the
    lifted state for the linear one --, What, alive, err) within 1e-5."""
    res = port_sim(kind).run_trial_mpc(blockM_reference(), x0=X0, u0=U0,
                                       steps=STEPS[kind])
    ref = jax_trial(kind, STEPS[kind])
    _hold(res, ref, ATOL[kind])
    assert res["alive"].all() and res["err"].shape == (STEPS[kind] - 1,)
    assert (res["T"] == np.arange(1, STEPS[kind]) * 0.05).all()


def test_timed_runner_is_the_trial_a_step_at_a_time():
    """``run_trial_mpc_timed``: the struct of ``run_trial_mpc`` with a
    measured ``comp_time`` of length K-1 (JAX's keys)."""
    steps = 8
    sim = port_sim("linear")
    res = sim.run_trial_mpc_timed(blockM_reference(), x0=X0, u0=U0,
                                  steps=steps)
    ref = sim.run_trial_mpc(blockM_reference(), x0=X0, u0=U0, steps=steps)
    assert set(res) == set(jax_trial("linear", STEPS["linear"]))
    assert res["comp_time"].shape == (steps - 1,)
    assert (res["comp_time"] > 0).all()
    for k in ref:
        if k != "comp_time":
            np.testing.assert_array_equal(res[k], ref[k], err_msg=k)


def _multi_refs():
    """Three references of different lengths (padded with their last
    row), the bench's blockM shifted."""
    y = blockM_y()
    return [y[:14], y[10:30], y[40:52]]


@pytest.mark.parametrize("kind", KINDS)
def test_run_batch_and_multi_ref_match_jax(kind):
    """``run_batch`` (a shared reference, cached runners) and
    ``run_multi_ref`` (a reference a lane, padded) against JAX's on three
    lanes: keys, shapes and every array within 1e-5 (the NMPC's
    ``run_multi_ref`` on its shapes and the bilinear one's values: each
    JAX NMPC program compiles for ~25 s)."""
    jsim, _, _ = jax_bench(kind)
    sim = port_sim(kind)
    B = 3
    X = bench_X0(B).astype(np.float64)
    W = np.zeros((B, 2))
    steps = STEPS[kind] // 2 + 1
    mine = sim.run_batch(blockM_reference(), X, W, steps=steps)
    assert len(sim._runner_cache) >= 1
    _hold(mine, jsim.run_batch(blockM_y(), X, W, steps=steps), ATOL[kind])
    refs = _multi_refs()
    mine = sim.run_multi_ref(refs, X, steps=steps)
    assert mine["Y"].shape == (B, steps - 1, 6)
    if kind == "nonlinear":
        assert set(mine) == {"Y", "R", "U", "alive", "err"}
        assert mine["alive"].all()
        return
    _hold(mine, jsim.run_multi_ref(refs, X, steps=steps), ATOL[kind])


def test_record_subsets_match_jax():
    """``batched_runner(record=...)``: every record of the JAX runner and
    the phase breakdown's three (the solve's zeta, scaled previous input
    and incoming plan) within 1e-5 of JAX's; a subset allocates and
    returns only its own records; the default keeps Yp and alive."""
    keys = RECORD_ALL + ("Yp", "zeta", "u_prev_sc", "U_plan_in")
    B, steps = 2, 10
    jsim, _, _ = jax_bench("bilinear")
    jout = jax.block_until_ready(jsim.batched_runner(
        blockM_y(), steps=steps, record=keys)(bench_X0(B), np.zeros((B, 2))))
    sim = port_sim("bilinear")
    out = sim.batched_runner(blockM_reference(), steps, record=keys)(
        bench_X0(B), np.zeros((B, 2)))
    assert set(out) == set(keys)
    for k in keys:
        a, b = out[k].numpy(), np.asarray(jout[k])
        assert a.shape == b.shape, k
        np.testing.assert_allclose(a.astype(float), b.astype(float),
                                   rtol=0, atol=1e-5, err_msg=k)
    sub = sim.batched_runner(blockM_reference(), steps, record=("U", "X"))(
        bench_X0(B), np.zeros((B, 2)))
    assert set(sub) == {"U", "X"}
    np.testing.assert_array_equal(sub["X"].numpy(), out["X"].numpy())
    assert set(sim.batched_runner(blockM_reference(), steps)(
        bench_X0(B), np.zeros((B, 2)))) == {"Yp", "alive"}
    with pytest.raises(ValueError, match="unknown records"):
        sim.batched_runner(blockM_reference(), steps, record=("Q",))


def test_time_varying_load_with_observer_matches_jax():
    """A (K, nw) load ramp on one trial of the loaded linear asset with
    its load observer, on the circle (``run_trial_mpc``, iteration k
    applying row k - 1, ksim.py:285-287): the struct within 1e-5 of JAX's,
    What moving with the load; a per-step (B, K, nw) load through the
    batch runner is the same loop."""
    steps = 30
    model, scaler, _ = load_model(LOADED_LINEAR_MODEL)
    cfg = MpcConfig(**{k: tuple(v) if isinstance(v, list) else v
                       for k, v in LOADED["mpc"].items()})
    mpc = make_kmpc(model, scaler, cfg, device="cpu", dtype=torch.float64)
    obs = make_load_observer(model, cfg, device="cpu", dtype=torch.float64)
    sim = Ksim(Arm(ArmConfig(**LOADED["arm"]), device="cpu"), mpc,
               observer=obs, device="cpu")
    X, W = loaded_lanes(1)
    load = np.tile(W[0], (steps, 1))
    load[:, 0] *= np.linspace(0.5, 1.5, steps)
    res = sim.run_trial_mpc(circle_reference(), x0=X[0], load=load,
                            steps=steps)
    ref = jax_loaded_sim("linear", True).run_trial_mpc(
        circle_y(), x0=X[0], load=load, steps=steps)
    _hold(res, ref)
    assert np.abs(res["What"]).max() > 0.1 and res["alive"].all()
    out = sim.batched_runner(circle_reference(), steps,
                             record=("Y", "what"))(X, load[None])
    np.testing.assert_array_equal(out["Y"][0].numpy(), res["Y"])
    np.testing.assert_array_equal(out["what"][0].numpy(), res["What"])


def test_run_model_simulation_matches_jax():
    """The closed loop against the linear asset itself from zeta 0: JAX's
    results struct (keys, shapes, arrays within 1e-5); a batch of zeta0
    rows gives ``run_batch``'s struct, lane 0 the trial's."""
    steps = 20
    mpc = port_sim("linear").mpc
    _, jmpc, _ = jax_bench("linear")
    res = run_model_simulation(mpc, blockM_reference(), steps=steps,
                               device="cpu")
    _hold(res, jax_run_model_simulation(jmpc, blockM_y(), steps=steps))
    batch = run_model_simulation(mpc, blockM_reference(), steps=steps,
                                 zeta0=np.zeros((2, 6)), device="cpu")
    assert set(batch) == {"U", "Y", "X", "R", "alive", "err"}
    np.testing.assert_allclose(batch["Y"][0], res["Y"], rtol=0, atol=1e-12)


def test_timing_helpers(tmp_path):
    """``step_time`` (seconds a step), ``phase_breakdown`` (the lift, the
    solve and the plant timed on the solve's recorded inputs; fractions
    summing to one) and ``profile_trace`` (a Chrome trace of the block)
    on the CPU."""
    sim = port_sim("bilinear")
    run = sim.batched_runner(blockM_reference(), 4)
    st = step_time(run, (bench_X0(2), np.zeros((2, 2))), 3, reps=2,
                   device="cpu")
    assert set(st) == {"mean", "median", "max", "total_s"}
    assert 0 < st["mean"] <= st["max"]
    pb = phase_breakdown(sim, blockM_reference(), B=4, steps=4, reps=1)
    assert {"lift", "mpc_solve", "plant_step"} <= set(pb)
    assert abs(sum(v["fraction_of_sum"] for k, v in pb.items()
                   if isinstance(v, dict)) - 1.0) < 1e-9
    assert pb["batch"] == 4 and pb["full_step_s"] > 0
    with profile_trace(tmp_path) as prof:
        run(bench_X0(2), np.zeros((2, 2)))
    assert (tmp_path / "trace.json").stat().st_size > 0
    assert len(prof.key_averages()) > 0
