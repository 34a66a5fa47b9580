"""The port's fused step (``ops/kernels/step_fused.py``) against the JAX
step-fused kernel (``ops/pallas/step_fused.py``, interpret mode) and
against the same step composed from the JAX package's pure x64 pieces.

One step at a time on the same carry (B=8, 20 closed-loop steps of the
JAX kernel):

- f64: the port's ``step_plain`` against the JAX x64 step (the lifted
  solve with ``backend="jax"``, ``sdirk2_soa`` on the previous input, the
  markers, the freeze and the carry advance), every field.  Both take the
  same f32-valued operands and differ only in the order of f64 operations:
  measured 6e-12 on the plant fields (the chord Newton amplifies Jacobian
  rounding, as in test_torch_arm.py) and 5e-14 on the QP fields, so the
  bounds are 1e-9 and 1e-10 (relative to the field's scale for lamc).
- f32: each output of ``step_plain`` is held against that f64 step, next
  to the TPU kernel's own f32 error.  The plant outputs (xpl, ysc, yp)
  carry the f32 noise of the chord-Newton SDIRK2 (its normal equations
  square the iteration matrix's condition number: ~1e-3 in both
  implementations), so the port's error may be at most four times the
  kernel's (measured 1.2x-1.7x at worst over 20 steps x 8 lanes, and 2.5x
  on the same lanes without joint rates); the QP outputs (upsc, x0, lamc)
  at most twice the kernel's plus 1e-5 (measured 0.09x-0.66x: the port's
  assembly is full f32, the kernel's 3-pass bf16).  The kernel's own f32
  error is bounded too, so a fault shared by both precisions of the port
  cannot loosen its own limit: 1e-2 on the plant fields, 5e-4 on upsc,
  2e-3 on x0 and 5e-4 of the scale on lamc (measured 1.4e-3, 6.5e-5,
  3.4e-4 and 7.7e-5; a wrong carry advance is off by 1e-1 or more).
  Alive masks must be equal.

Two more steps take a different reference window in every lane (sqYr of
shape (p, B)); the QP outputs, which the windows drive, are held to the
same bounds (measured: f64 5e-14, TPU f32 2e-5..3e-4, port f32
0.01x-0.14x of the TPU kernel's error).

The port's fused runner against the JAX ``fused_runner`` (B=4, 30 steps):
equal alive masks; both are f32 closed loops whose ~1e-3 per-step plant
noise the feedback keeps bounded, measured max |dYp| 4.9e-3 (1.6e-3 over
the first 5 steps), so the bounds are 1e-2 and 3.5e-3.
"""

import inspect

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from koopman_realizations_tpu.models.arm_lanes import sdirk2_soa
from koopman_realizations_tpu.ops.pallas.step_fused import (
    build_step_fused as jax_build_step_fused,
)
from koopman_realizations_tpu.ops.qp import _solve_qp_bilinear_lifted

from koopman_realizations_torch.config import ArmConfig, MpcConfig
from koopman_realizations_torch.control.kmpc import BilinearKmpc
from koopman_realizations_torch.control.ksim import Ksim
from koopman_realizations_torch.models.arm import Arm
from koopman_realizations_torch.ops.kernels.step_fused import (
    StepCarry,
    build_step_fused,
)
from koopman_realizations_torch.ops.qp import lift_qp_operands
from koopman_realizations_torch.utils.checkpoint import load_model

from test_torch_oracle import (
    BENCH_ARM,
    BENCH_MPC,
    bench_X0,
    blockM_y,
    jax_bench,
)

PLANT = ("ysc", "xpl", "yp")
QP = ("upsc", "x0", "lamc")
GEN_KEYS = ("Gz", "Gm", "Gb", "Hz", "Hm", "Hb", "Pz", "Pm", "Pb")
B = 8
# bounds of the TPU kernel's own f32 error against the f64 step
TPU_F32 = dict(ysc=1e-2, xpl=1e-2, yp=1e-2, upsc=5e-4, x0=2e-3, lamc=5e-4)


def _port(dtype, **arm):
    model, scaler, _ = load_model()
    mpc = BilinearKmpc(model, scaler, MpcConfig(**BENCH_MPC), device="cpu",
                       dtype=dtype)
    arm = Arm(ArmConfig(**{**BENCH_ARM, **arm}), device="cpu")
    return Ksim(arm, mpc, device="cpu")


def _port64_op():
    """The port's f64 fused step on the f32-valued operands the JAX
    package holds, so it and the JAX x64 step solve the same problem."""
    sim = _port(torch.float64)
    mpc = sim.mpc
    f32 = lambda a: np.asarray(a, np.float32).astype(np.float64)
    op = build_step_fused(mpc, sim.plant, sim.scaler)
    op.qp = lift_qp_operands({k: f32(v) for k, v in mpc.lift_gens.items()},
                             mpc.lift_tables, f32(mpc.RdT), f32(mpc.F_red),
                             f32(mpc.cF_red), f32(mpc.F0_red), mpc.band,
                             dtype=torch.float64, device="cpu")
    return op


def _jax_x64_step(jmpc, jarm, Pwarm):
    """The fused step composed from the JAX package's pure x64 pieces, as
    one jitted function of a lanes-minor f64 carry and sqYr: the lifted
    solve (``backend="jax"``) from the carried starts, SDIRK2 of the arm on
    the previous input, the markers, the alive freeze and the carry advance
    (step_fused.py:90-182 of the JAX package)."""
    c = jmpc.consts()
    gens = [c["LF_" + k] for k in GEN_KEYS]
    row = jnp.maximum(jnp.abs(jnp.asarray(c["FjT"], jnp.float64)).max(1),
                      1e-10)[:, None]
    a = jarm.cfg

    def one(z, up, x, lam, s):
        return _solve_qp_bilinear_lifted(
            z, up, s, *gens, c["RdT"], c["FjT"], c["cFjT"], c["F0T"],
            jmpc._lift_tables, jmpc.cfg.qp_iters, x, "jax", jmpc._band, lam)

    def step(carry, sqYr):
        ysc, upsc, xpl, w, alive, x0, lamc, yp = carry
        sq = sqYr.T if sqYr.ndim == 2 else \
            jnp.broadcast_to(sqYr, (ysc.shape[1], sqYr.shape[0]))
        sol = jax.vmap(one)(ysc.T, upsc.T, x0.T, (lamc / row).T, sq)
        x = sol.x.T
        xs = sdirk2_soa(a, jarm._G, jarm._b, xpl.T,
                        jmpc.scaler.u_up(upsc.T), w.T, a.Ts, a.substeps,
                        a.newton_iters, a.jac_mode)
        y = jarm.get_y_batch(xs)
        keep = (alive > 0.5) & sol.ok & jnp.isfinite(xs).all(1)
        sel = lambda new, old: jnp.where(keep, new, old)
        return dict(ysc=sel(jmpc.scaler.y_down(y).T, ysc),
                    upsc=sel(x[:upsc.shape[0]], upsc), xpl=sel(xs.T, xpl),
                    alive=keep.astype(jnp.float64), x0=sel(Pwarm @ x, x0),
                    lamc=sel(sol.lam.T * row, lamc),
                    yp=sel(y[:, list(jmpc.proj_idx)].T, yp))

    return jax.jit(step)


class _Steps:
    """Runs one step of every implementation on the same carry and keeps
    the worst errors: {field: [port32 vs port64, tpu32 vs port64,
    port64 vs jax64]}."""

    SHAPES = dict(ysc=(6, B), upsc=(3, B), xpl=(6, B), w=(2, B),
                  alive=(B,), x0=(12, B), lamc=(48, B), yp=(2, B))

    def __init__(self):
        self.sim, self.jmpc, self.jarm = jax_bench()
        step_fn, self.init, _ = jax_build_step_fused(
            self.jmpc, self.jarm, self.jmpc.scaler, tile=8, interpret=True)
        operands = inspect.getclosurevars(step_fn).nonlocals["operands"]
        self.step_fn = jax.jit(step_fn)
        self.jax64 = _jax_x64_step(self.jmpc, self.jarm,
                                   jnp.asarray(operands[7], jnp.float64))
        sim32 = _port(torch.float32)
        self.op32 = build_step_fused(sim32.mpc, sim32.plant, sim32.scaler)
        self.op64 = _port64_op()
        self.worst = {k: [0.0, 0.0, 0.0] for k in PLANT + QP}
        self.lam_scale = 1.0          # max |lamc| of the f64 steps, >= 1

    def carry(self, X0):
        return self.init(jnp.asarray(X0), jnp.zeros((B, 2), jnp.float32))

    def step(self, carry, sqYr):
        """sqYr: f32 numpy (p,) or (p, B).  Returns the JAX kernel's new
        carry."""
        jnew, _ = self.step_fn(carry, jnp.asarray(sqYr))
        jd = {f: np.asarray(a).reshape(self.SHAPES[f])
              for f, a in zip(StepCarry._fields, jnew)}
        cin = {dt: StepCarry(*(torch.from_numpy(
            np.array(a, dt).reshape(self.SHAPES[f]))
            for a, f in zip(carry, StepCarry._fields)))
            for dt in (np.float32, np.float64)}
        p32 = self.op32.step_plain(cin[np.float32], torch.from_numpy(sqYr))
        sq64 = np.asarray(sqYr, np.float64)
        p64 = self.op64.step_plain(cin[np.float64], torch.from_numpy(sq64))
        j64 = {f: np.asarray(a) for f, a in self.jax64(
            tuple(jnp.asarray(t.numpy()) for t in cin[np.float64]),
            jnp.asarray(sq64)).items()}
        np.testing.assert_array_equal(p32.alive.numpy(), jd["alive"])
        np.testing.assert_array_equal(p64.alive.numpy(), j64["alive"])
        self.lam_scale = max(self.lam_scale, p64.lamc.abs().max().item())
        for f, w in self.worst.items():
            ref = getattr(p64, f).numpy()
            w[0] = max(w[0], np.abs(getattr(p32, f).numpy() - ref).max())
            w[1] = max(w[1], np.abs(jd[f] - ref).max())
            w[2] = max(w[2], np.abs(j64[f] - ref).max())
        return tuple(jnew)


def _window(sim, jmpc, k):
    """sqrt(Q) * Yr of step k as the JAX runner forms it (f32)."""
    sq = np.sqrt(np.asarray(jmpc.Qd, np.float32))
    ref = sim.prep_ref(blockM_y()).astype(np.float32)
    return sq * ref[k:k + jmpc.Np + 1].reshape(-1)


@pytest.fixture(scope="module")
def stepwise():
    """Worst per-output errors over 20 steps with the shared window."""
    s = _Steps()
    X0 = bench_X0(B)
    X0[:, 3] = np.linspace(-0.3, 0.3, B)          # some joint rates too
    carry = s.carry(X0)
    for k in range(20):
        carry = s.step(carry, _window(s.sim, s.jmpc, k))
    assert np.asarray(carry[4]).all()
    return s


@pytest.fixture(scope="module")
def per_lane():
    """Worst per-output errors of two steps with a different reference
    window in every lane."""
    s = _Steps()
    carry = s.carry(bench_X0(B))
    for k in range(2):
        sq = np.stack([_window(s.sim, s.jmpc, k + 25 * b) for b in range(B)],
                      axis=1)
        carry = s.step(carry, np.ascontiguousarray(sq))
    assert np.asarray(carry[4]).all()
    return s


def _check_f64(s, field):
    """port64 against the JAX x64 step."""
    scale = s.lam_scale if field == "lamc" else 1.0
    d = s.worst[field][2]
    assert d <= (1e-9 if field in PLANT else 1e-10) * scale, (field, d)


def _check_tpu(s, field):
    """The TPU kernel's own f32 error against the f64 step."""
    scale = s.lam_scale if field == "lamc" else 1.0
    tpu = s.worst[field][1]
    assert tpu <= TPU_F32[field] * scale, (field, tpu)


@pytest.mark.parametrize("field", PLANT + QP)
def test_step_f64_matches_jax_x64(stepwise, field):
    _check_f64(stepwise, field)


@pytest.mark.parametrize("field", PLANT)
def test_step_plant_outputs_match_tpu_kernel(stepwise, field):
    _check_tpu(stepwise, field)
    port, tpu, _ = stepwise.worst[field]
    assert port <= 4.0 * tpu + 1e-5, (field, port, tpu)


@pytest.mark.parametrize("field", QP)
def test_step_qp_outputs_match_tpu_kernel(stepwise, field):
    _check_tpu(stepwise, field)
    port, tpu, _ = stepwise.worst[field]
    assert port <= 2.0 * tpu + 1e-5, (field, port, tpu)


@pytest.mark.parametrize("field", QP)
def test_step_per_lane_windows_match_jax(per_lane, field):
    _check_f64(per_lane, field)
    _check_tpu(per_lane, field)
    port, tpu, _ = per_lane.worst[field]
    assert port <= 2.0 * tpu + 1e-5, (field, port, tpu)


def test_fused_runner_matches_jax_fused_runner():
    sim, _, _ = jax_bench()
    psim = _port(torch.float32)
    assert psim.fused_step_eligible()
    B, steps = 4, 30
    X0 = bench_X0(B)
    W = np.zeros((B, 2), np.float32)
    jout = jax.block_until_ready(
        sim.fused_runner(blockM_y(), steps=steps, tile=4)(X0, W))
    out = psim.fused_runner(blockM_y(), steps=steps)(X0, W)
    assert out["Yp"].shape == (B, steps - 1, 2)
    alive = out["alive"].numpy()
    np.testing.assert_array_equal(alive, np.asarray(jout["alive"]))
    assert alive.all()
    d = np.abs(out["Yp"].numpy() - np.asarray(jout["Yp"]))
    assert d.max() < 1e-2, d.max()
    assert d[:, :5].max() < 3.5e-3, d[:, :5].max()


def test_fused_runner_rejects_f64():
    """The kernel is f32: an f64 controller is not eligible (no cast)."""
    psim = _port(torch.float64)
    assert not psim.fused_step_eligible()
    with pytest.raises(ValueError):
        psim.fused_runner(blockM_y(), steps=5)


@pytest.mark.parametrize("arm", [dict(output_type="endeff"),
                                 dict(output_type="shape")])
def test_fused_runner_rejects_other_plants(arm):
    """The fused step takes marker or angle outputs (JAX
    ``_fused_plant_ok``); arms with other outputs go through
    ``batched_runner``."""
    psim = _port(torch.float32, **arm)
    assert not psim.fused_step_eligible()
    with pytest.raises(ValueError):
        psim.fused_runner(blockM_y(), steps=5)
    with pytest.raises(NotImplementedError):
        build_step_fused(psim.mpc, psim.plant, psim.scaler)
