"""The port's fused LINEAR step (``ops/kernels/linear_step_fused.py``)
against the JAX linear step kernel (``_linear_step_call`` of
``ops/pallas/step_fused.py``, interpret mode) and against the same step
composed from the JAX package's pure x64 pieces.

One step at a time on the same carry (B=8, 20 closed-loop steps of the
JAX kernel, the linear controller at qp_iters=6 with cold duals):

- f64: the port's ``step_plain`` (f64 controller) against a JAX x64 step
  composed from ``LinearKmpc.solve``'s pieces -- the basis lift, the
  condensed gradient, ``_eliminate_u0``, ``solve_qp`` (``backend="jax"``)
  from the carried primal start, cold duals -- and ``sdirk2_soa`` on the
  previous input, the markers, the freeze and the carry advance, every
  field.  The fused step equilibrates by max |2H| over the full Hessian,
  the general solve by max |P22|; on this model both are the same entry
  (12.288, asserted), so the two solve the same scaled problem and the
  dual carry (equilibrated multipliers) compares directly.  Only the order
  of f64 operations differs: measured 1.1e-11 on the plant fields (the
  chord Newton amplifies Jacobian rounding, as in test_torch_arm.py) and
  2.7e-13 on the QP fields, bound 1e-10 (relative to the scale for lamc).
- f32: each output of ``step_plain`` is held against that f64 step, next
  to the TPU kernel's own f32 error, with the rules of
  test_torch_step_fused.py: plant outputs (xpl, ysc, yp; the chord-Newton
  SDIRK2's f32 noise) at most four times the kernel's + 1e-5 (measured
  1.6x-1.8x), QP outputs (upsc, x0, lamc) at most twice the kernel's +
  1e-5 (of the scale for lamc; measured 0.19x-0.45x: the port's gradient
  is full f32, the kernel's 3-pass bf16, and six cold-started iterations
  amplify that to 2.2e-3 on upsc).  The kernel's own f32 error is bounded
  too, at about three times its measured worst (TPU_F32: measured 3.4e-3
  on xpl, 2.2e-3 on upsc, 2.0e-3 on x0, 1e-5 on lamc), and alive masks
  must be equal.
"""

import inspect

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from koopman_realizations_tpu.models.arm_lanes import sdirk2_soa
from koopman_realizations_tpu.ops.pallas.step_fused import (
    build_linear_step_fused as jax_build_linear_step_fused,
)
from koopman_realizations_tpu.ops.qp import solve_qp

from koopman_realizations_torch.config import ArmConfig, MpcConfig
from koopman_realizations_torch.control.kmpc import LinearKmpc
from koopman_realizations_torch.control.ksim import Ksim
from koopman_realizations_torch.models.arm import Arm
from koopman_realizations_torch.ops.kernels.linear_step_fused import (
    build_linear_step_fused,
)
from koopman_realizations_torch.ops.kernels.step_fused import StepCarry
from koopman_realizations_torch.utils.checkpoint import (
    LINEAR_MODEL,
    load_model,
)
from test_torch_oracle import (
    BENCH_ARM,
    LINEAR_MPC,
    bench_X0,
    blockM_y,
    jax_bench,
)
from test_torch_oracle import one_thread  # noqa: E402,F401  (fixture)

# one torch thread a test process: the xdist workers' pools would
# oversubscribe the machine
pytestmark = pytest.mark.usefixtures("one_thread")

PLANT = ("ysc", "xpl", "yp")
QP = ("upsc", "x0", "lamc")
B = 8
# bounds of the TPU kernel's own f32 error against the f64 step
TPU_F32 = dict(ysc=1e-2, xpl=1e-2, yp=1e-2, upsc=6e-3, x0=6e-3, lamc=3e-5)


def _sim(dtype):
    model, scaler, _ = load_model(LINEAR_MODEL)
    mpc = LinearKmpc(model, scaler, MpcConfig(**LINEAR_MPC), device="cpu",
                     dtype=dtype)
    return Ksim(Arm(ArmConfig(**BENCH_ARM), device="cpu"), mpc,
                device="cpu")


def _jax_x64_step(jmpc, jarm, Pwarm):
    """The fused linear step composed from the JAX package's pure x64
    pieces, as one jitted function of a lanes-minor f64 carry and the
    scaled reference window Yr (p,)."""
    m = jmpc.m
    Az = jnp.asarray(jmpc.L)[:, m:]
    row = jnp.maximum(jnp.abs(Az).max(1), 1e-10)
    P = 2.0 * jmpc.H
    obj = jnp.maximum(jnp.abs(P[m:, m:]).max(), 1e-8)
    a = jarm.cfg

    def one(zeta, up, x0, Yr):
        z = jmpc.model.basis.lift(zeta)
        f = 2.0 * jmpc.CB.T @ (jmpc.Qd * (jmpc.CA @ z - Yr))
        b = jmpc.c - jmpc.Mc @ z
        Pz, fz, Az_, bz = jmpc._eliminate_u0(P, f, jmpc.L, b, up)
        sol = solve_qp(Pz, fz, Az_, bz, iters=jmpc.cfg.qp_iters, x0=x0,
                       shared_A=True, backend="jax",
                       band_offset=jmpc._band)
        return sol.x, sol.lam * row / obj, sol.ok

    def step(carry, Yr):
        ysc, upsc, xpl, w, alive, x0, lamc, yp = carry
        x, lam, ok = jax.vmap(one, in_axes=(0, 0, 0, None))(
            ysc.T, upsc.T, x0.T, Yr)
        x, lam = x.T, lam.T
        xs = sdirk2_soa(a, jarm._G, jarm._b, xpl.T,
                        jmpc.scaler.u_up(upsc.T), w.T, a.Ts, a.substeps,
                        a.newton_iters, a.jac_mode)
        y = jarm.get_y_batch(xs)
        keep = (alive > 0.5) & ok & jnp.isfinite(xs).all(1)
        sel = lambda new, old: jnp.where(keep, new, old)
        return dict(ysc=sel(jmpc.scaler.y_down(y).T, ysc),
                    upsc=sel(x[:m], upsc), xpl=sel(xs.T, xpl),
                    alive=keep.astype(jnp.float64), x0=sel(Pwarm @ x, x0),
                    lamc=sel(lam, lamc),
                    yp=sel(y[:, list(jmpc.proj_idx)].T, yp))

    return jax.jit(step), float(obj)


class _Steps:
    """Runs one step of every implementation on the same carry and keeps
    the worst errors: {field: [port32 vs port64, tpu32 vs port64,
    port64 vs jax64]}."""

    SHAPES = dict(ysc=(6, B), upsc=(3, B), xpl=(6, B), w=(2, B),
                  alive=(B,), x0=(12, B), lamc=(48, B), yp=(2, B))

    def __init__(self):
        self.sim, self.jmpc, self.jarm = jax_bench("linear")
        step_fn, self.init, self.fYr_fn, _ = jax_build_linear_step_fused(
            self.jmpc, self.jarm, self.jmpc.scaler, tile=8, interpret=True)
        operands = inspect.getclosurevars(step_fn).nonlocals["operands"]
        self.step_fn = jax.jit(step_fn)
        self.jax64, self.obj22 = _jax_x64_step(
            self.jmpc, self.jarm, jnp.asarray(operands[7], jnp.float64))
        sim32, sim64 = _sim(torch.float32), _sim(torch.float64)
        self.op32 = build_linear_step_fused(sim32.mpc, sim32.plant,
                                            sim32.scaler)
        self.op64 = build_linear_step_fused(sim64.mpc, sim64.plant,
                                            sim64.scaler)
        self.worst = {k: [0.0, 0.0, 0.0] for k in PLANT + QP}
        self.lam_scale = 1.0          # max |lamc| of the f64 steps, >= 1

    def carry(self, X0):
        return self.init(jnp.asarray(X0), jnp.zeros((B, 2), jnp.float32))

    def step(self, carry, Yr):
        """Yr: f64 numpy (p,) scaled window.  Returns the JAX kernel's new
        carry."""
        Yr32 = np.asarray(Yr, np.float32)
        jnew, _ = self.step_fn(carry, self.fYr_fn(jnp.asarray(Yr32)))
        jd = {f: np.asarray(a).reshape(self.SHAPES[f])
              for f, a in zip(StepCarry._fields, jnew)}
        cin = {dt: StepCarry(*(torch.from_numpy(
            np.array(a, dt).reshape(self.SHAPES[f]))
            for a, f in zip(carry, StepCarry._fields)))
            for dt in (np.float32, np.float64)}
        p32 = self.op32.step_plain(
            cin[np.float32], self.op32.fYr(torch.from_numpy(Yr32)[None])[0])
        p64 = self.op64.step_plain(
            cin[np.float64], self.op64.fYr(torch.from_numpy(Yr)[None])[0])
        j64 = {f: np.asarray(a) for f, a in self.jax64(
            tuple(jnp.asarray(t.numpy()) for t in cin[np.float64]),
            jnp.asarray(Yr)).items()}
        np.testing.assert_array_equal(p32.alive.numpy(), jd["alive"])
        np.testing.assert_array_equal(p64.alive.numpy(), j64["alive"])
        self.lam_scale = max(self.lam_scale, p64.lamc.abs().max().item())
        for f, w in self.worst.items():
            ref = getattr(p64, f).numpy()
            w[0] = max(w[0], np.abs(getattr(p32, f).numpy() - ref).max())
            w[1] = max(w[1], np.abs(jd[f] - ref).max())
            w[2] = max(w[2], np.abs(j64[f] - ref).max())
        return tuple(jnew)


@pytest.fixture(scope="module")
def stepwise():
    """Worst per-output errors over 20 steps."""
    s = _Steps()
    assert s.op64.obj == s.obj22          # both routes scale alike here
    X0 = bench_X0(B)
    X0[:, 3] = np.linspace(-0.3, 0.3, B)          # some joint rates too
    carry = s.carry(X0)
    ref = s.sim.prep_ref(blockM_y())
    Np = s.jmpc.Np
    for k in range(20):
        carry = s.step(carry, ref[k:k + Np + 1].reshape(-1))
    assert np.asarray(carry[4]).all()
    return s


def _check_tpu(s, field):
    """The TPU kernel's own f32 error against the f64 step."""
    scale = s.lam_scale if field == "lamc" else 1.0
    tpu = s.worst[field][1]
    assert tpu <= TPU_F32[field] * scale, (field, tpu)


@pytest.mark.parametrize("field", PLANT + QP)
def test_linear_step_f64_matches_jax_x64(stepwise, field):
    scale = stepwise.lam_scale if field == "lamc" else 1.0
    d = stepwise.worst[field][2]
    assert d <= 1e-10 * scale, (field, d)


@pytest.mark.parametrize("field", PLANT)
def test_linear_step_plant_outputs_match_tpu_kernel(stepwise, field):
    _check_tpu(stepwise, field)
    port, tpu, _ = stepwise.worst[field]
    assert port <= 4.0 * tpu + 1e-5, (field, port, tpu)


@pytest.mark.parametrize("field", QP)
def test_linear_step_qp_outputs_match_tpu_kernel(stepwise, field):
    _check_tpu(stepwise, field)
    port, tpu, _ = stepwise.worst[field]
    scale = stepwise.lam_scale if field == "lamc" else 1.0
    assert port <= 2.0 * tpu + 1e-5 * scale, (field, port, tpu)
