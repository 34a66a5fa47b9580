"""The port's arm plant (``models/arm_lanes.py``, ``models/arm.py``)
against the JAX ``sdirk2_soa`` and ``get_y_batch`` on random states of
closed-loop size (angles ~0.2 rad, rates ~0.3 rad/s, inputs within 0.6).

f64: the two differ only in the order of floating-point operations (the
port's Jacobian comes from one dual-number pass instead of n ``jax.jvp``
passes).  The chord Newton with one iteration per stage carries the
Jacobian's rounding straight into the state, amplified by the stiff
iteration matrix: measured 2.3e-11 with one Newton iteration and 2e-13
with two, so the bound is 1e-10 and 1e-12.

f32: the normal-equation factorization squares the iteration matrix's
condition number, and the JAX code's own f32 result is 4e-3..9e-3 away
from its f64 result with one Newton iteration.  The port in f32 is held
to the same accuracy: its distance from the JAX f64 result may be at most
three times the JAX f32 result's (measured ratio <= 1.9).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from koopman_realizations_tpu.config import ArmConfig as JArmConfig
from koopman_realizations_tpu.models.arm import Arm as JArm
from koopman_realizations_tpu.models.arm_lanes import sdirk2_soa

from koopman_realizations_torch.config import ArmConfig
from koopman_realizations_torch.models.arm import Arm

from test_torch_oracle import BENCH_ARM


def _inputs(B=16, seed=0):
    rng = np.random.default_rng(seed)
    X = np.concatenate([rng.normal(0, 0.2, (B, 3)),
                        rng.normal(0, 0.3, (B, 3))], axis=1)
    U = rng.uniform(-0.6, 0.6, (B, 3))
    W = np.stack([rng.uniform(0, 0.1, B), rng.uniform(-0.1, 0.1, B)], 1)
    return X, U, W


def _jax_step(cfg_kw, X, U, W):
    jarm = JArm(JArmConfig(**cfg_kw))
    c = jarm.cfg
    return np.asarray(sdirk2_soa(c, jarm._G, jarm._b, jnp.asarray(X),
                                 jnp.asarray(U), jnp.asarray(W), c.Ts,
                                 c.substeps, c.newton_iters, c.jac_mode),
                      np.float64)


def _port_step(cfg_kw, X, U, W):
    arm = Arm(ArmConfig(**cfg_kw), device="cpu")
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a.T))
    out = arm.step(t(X), t(U), t(W))
    assert out.dtype == torch.from_numpy(X).dtype
    return out.numpy().T.astype(np.float64)


@pytest.mark.parametrize("newton,jac_mode", [(1, "step"), (2, "step"),
                                             (1, "substep"),
                                             (2, "substep")])
def test_sdirk2_rows_matches_jax(newton, jac_mode):
    kw = {**BENCH_ARM, "newton_iters": newton, "jac_mode": jac_mode}
    X, U, W = _inputs()
    ref64 = _jax_step(kw, X, U, W)
    assert np.isfinite(ref64).all()
    np.testing.assert_allclose(_port_step(kw, X, U, W), ref64, rtol=0,
                               atol=1e-10 if newton == 1 else 1e-12)
    f32 = [a.astype(np.float32) for a in (X, U, W)]
    jax_err = np.abs(_jax_step(kw, *f32) - ref64).max()
    port_err = np.abs(_port_step(kw, *f32) - ref64).max()
    assert port_err <= 3.0 * jax_err, (port_err, jax_err)


@pytest.mark.parametrize("dtype,tol", [("float64", 1e-14),
                                       ("float32", 1e-6)])
def test_markers_match_jax(dtype, tol):
    jarm = JArm(JArmConfig(**BENCH_ARM))
    arm = Arm(ArmConfig(**BENCH_ARM), device="cpu")
    X = _inputs()[0].astype(dtype)
    ref = np.asarray(jarm.get_y_batch(jnp.asarray(X)))
    got = arm.get_y_batch(torch.from_numpy(X)).numpy()
    assert got.shape == (16, 6)
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol)
