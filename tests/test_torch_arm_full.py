"""The port's arm in full (``models/arm.py``, ``models/arm_lanes.py``,
``config.py:ArmConfig``) against the JAX ``Arm`` on the same numpy-seeded
inputs, f64 unless stated.

Tolerances, each with what it was measured at:
- ``mass_matrix`` against ``_mass_matrix_autodiff`` and JAX: 1e-13
  (measured 0 and 3e-17);
- ``accel`` / ``rhs`` (torch.func autodiff), ``rhs_lanes`` (stacked
  closed form) and ``rhs_soa`` (rows) against JAX's autodiff ``rhs``:
  1e-12 relative to the largest acceleration (|addot| reaches ~1e3 on
  these lanes;
  measured 2e-12 absolute, 2e-15 relative);
- ``get_y`` of all four outputs: 1e-14 in f64 (measured 0), 1e-6 in
  f32; 'shape' the same times the fit's pseudo-inverse's largest
  absolute row sum (its least-squares fit amplifies the rounding of the
  marker positions; measured 1e-15 and 2.6e-14);
- ``ramp_and_hold``: bitwise;
- ``Arm.step`` with 'rk4' (200 substeps), 'rk45' and SDIRK2 'stage' over
  5 periods of 4 lanes against JAX ``simulate_Ts`` under ``vmap`` (JAX's
  autodiff RHS; the port's closed form): 1e-10 (measured 1e-16, 8e-15,
  1e-16).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from koopman_realizations_tpu import config as JCfg
from koopman_realizations_tpu.models.arm import Arm as JArm

from koopman_realizations_torch import config as TCfg
from koopman_realizations_torch.config import ArmConfig
from koopman_realizations_torch.models.arm import Arm
from koopman_realizations_torch.models.arm_lanes import rhs_soa

from test_torch_oracle import one_thread  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("one_thread")

BASE = dict(Nmods=3, nlinks=1, L=1.0, m=0.1)
GEOMETRIES = [dict(BASE), dict(Nmods=2, nlinks=1, L=1.0, m=0.1),
              dict(Nmods=2, nlinks=2, L=0.75, m=0.3)]


def _lanes(N: int, B: int, seed: int):
    """(X (B, 2N), U (B, Nmods), W (B, 2)) of closed-loop size."""
    rng = np.random.default_rng(seed)
    X = np.concatenate([rng.normal(0, 0.3, (B, N)),
                        rng.normal(0, 0.4, (B, N))], axis=1)
    return X, rng.uniform(-0.6, 0.6, (B, N)), \
        np.stack([rng.uniform(0, 0.5, B), rng.uniform(-0.3, 0.3, B)], 1)


def _pair(**kw):
    return JArm(JCfg.ArmConfig(**kw)), Arm(ArmConfig(**kw), device="cpu")


def test_config_matches_jax():
    """Every field, default and derived size of ``ArmConfig`` is the JAX
    package's, for each output; ``to_json`` writes the same JSON and
    ``from_json`` reads it back."""
    jf = {f.name: f.default for f in dataclasses.fields(JCfg.ArmConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(ArmConfig)}
    assert jf == tf
    for ot in ("angles", "markers", "endeff", "shape"):
        for geo in GEOMETRIES:
            j, t = JCfg.ArmConfig(**geo, output_type=ot), \
                ArmConfig(**geo, output_type=ot)
            for p in ("Nlinks", "l", "i", "nx", "nu", "nw", "markerPos",
                      "ny"):
                assert getattr(j, p) == getattr(t, p), (p, ot, geo)
            assert TCfg.to_json(t) == JCfg.to_json(j)
            assert TCfg.from_json(ArmConfig, TCfg.to_json(t)) == t
    sc = TCfg.SysidConfig(model_type="bilinear", obs_degree=(3,))
    assert TCfg.from_json(TCfg.SysidConfig, TCfg.to_json(sc)) == sc


@pytest.mark.parametrize("geo", GEOMETRIES)
def test_mass_matrix_and_energy(geo):
    """The closed-form mass matrix equals the reference's Jacobian
    products and JAX's, for loaded arms too; the potential energy,
    input torque and kinematics are JAX's."""
    jarm, arm = _pair(**geo)
    N = arm.nlinks
    X, U, W = _lanes(N, 5, seed=3)
    for x, u, w in zip(X, U, W):
        a, wt = torch.from_numpy(x[:N]), torch.from_numpy(w)
        ja, jw = jnp.asarray(x[:N]), jnp.asarray(w)
        Dq = arm.mass_matrix(a, wt).numpy()
        np.testing.assert_allclose(Dq, np.asarray(jarm.mass_matrix(ja, jw)),
                                   rtol=0, atol=1e-13)
        np.testing.assert_allclose(arm._mass_matrix_autodiff(a, wt).numpy(),
                                   Dq, rtol=0, atol=1e-13)
        assert abs(float(arm.potential_energy(a, wt))
                   - float(jarm.potential_energy(ja, jw))) < 1e-13
        np.testing.assert_allclose(
            arm.input_torque(a, torch.from_numpy(u[:geo["Nmods"]])).numpy(),
            np.asarray(jarm.input_torque(ja, jnp.asarray(u[:geo["Nmods"]]))),
            rtol=0, atol=1e-14)
        for mine, ref in zip(arm.joint_positions(a),
                             jarm.joint_positions(ja)):
            np.testing.assert_allclose(mine.numpy(), np.asarray(ref),
                                       rtol=0, atol=1e-15)


@pytest.mark.parametrize("geo", GEOMETRIES)
def test_rhs_forms_match_jax(geo):
    """accel / rhs by torch.func, ``rhs_lanes`` and ``rhs_soa`` against
    JAX's autodiff rhs, 1e-12 relative to the largest acceleration."""
    jarm, arm = _pair(**geo)
    N, B = arm.nlinks, 8
    X, U, W = _lanes(N, B, seed=5)
    U = U[:, :geo["Nmods"]]
    ref = np.stack([np.asarray(jarm.rhs(jnp.asarray(x), jnp.asarray(u),
                                        jnp.asarray(w)))
                    for x, u, w in zip(X, U, W)])
    tol = 1e-12 * np.abs(ref).max()
    own = np.stack([arm.rhs(*map(torch.from_numpy, (x, u, w))).numpy()
                    for x, u, w in zip(X, U, W)])
    np.testing.assert_allclose(own, ref, rtol=0, atol=tol)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a.T))
    lanes = arm.lane_rhs(t(U), t(W))(t(X)).numpy().T
    np.testing.assert_allclose(lanes, ref, rtol=0, atol=tol)
    rows = rhs_soa(arm.cfg, arm.G_host, arm.b_host, list(t(X)[:N]),
                   list(t(X)[N:]), list(t(U)), t(W)[0], t(W)[1])
    np.testing.assert_allclose(torch.stack(rows).numpy().T, ref[:, N:],
                               rtol=0, atol=tol)
    # the stage Jacobian of arm_lanes' dual numbers is rhs_lanes'
    J = arm.lane_jacobian(t(U), t(W))(t(X)).numpy()
    Jf = torch.func.jacfwd(lambda x: arm.rhs(x, torch.from_numpy(U[0]),
                                             torch.from_numpy(W[0])))(
        torch.from_numpy(X[0])).numpy()
    np.testing.assert_allclose(J[..., 0], Jf, rtol=0,
                               atol=1e-12 * np.abs(Jf).max())


@pytest.mark.parametrize("dtype,tol", [("float64", 1e-14),
                                       ("float32", 1e-6)])
@pytest.mark.parametrize("ot", ["angles", "markers", "endeff", "shape"])
@pytest.mark.parametrize("geo", [GEOMETRIES[0], GEOMETRIES[2]])
def test_outputs_match_jax(geo, ot, dtype, tol):
    """``get_y_batch`` (row-major) and ``get_y`` (lanes-minor, and one
    lane) of every output; 'shape' keeps the reference's [sin, cos]
    end tangent, its bound scaled by the fit's largest absolute row sum
    of the pseudo-inverse (47 for 3 modules, 409 for the 2-module arm
    of 0.75 m: measured 2.6e-14 there in f64)."""
    jarm, arm = _pair(**geo, output_type=ot)
    if ot == "shape":
        tol *= np.abs(arm._shape_obs_matrix).sum(1).max()
    X = _lanes(arm.nlinks, 16, seed=7)[0].astype(dtype)
    ref = np.asarray(jarm.get_y_batch(jnp.asarray(X)))
    got = arm.get_y_batch(torch.from_numpy(X)).numpy()
    assert got.shape == (16, arm.cfg.ny) and got.dtype == X.dtype
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol)
    np.testing.assert_allclose(arm.get_y(torch.from_numpy(X[0])).numpy(),
                               ref[0], rtol=0, atol=tol)


def test_shape_curve_and_markers():
    """``get_markers``, ``shape_coeffs`` and ``shape_curve`` of one lane
    are JAX's; the shape fit's pseudo-inverse too."""
    jarm, arm = _pair(**BASE, output_type="shape")
    np.testing.assert_array_equal(arm._shape_obs_matrix,
                                  jarm._shape_obs_matrix)
    a = _lanes(3, 1, seed=9)[0][0, :3]
    ta, ja = torch.from_numpy(a), jnp.asarray(a)
    for mine, ref in ((arm.get_markers(ta), jarm.get_markers(ja)),
                      (arm.shape_coeffs(ta), jarm.shape_coeffs(ja)),
                      (arm.shape_curve(ta, 51), jarm.shape_curve(ja, 51))):
        np.testing.assert_allclose(mine.numpy(), np.asarray(ref), rtol=0,
                                   atol=1e-14)


def test_ramp_and_hold_bitwise():
    """The same seeded Generator draws the same tables, bitwise."""
    jarm, arm = _pair(**BASE, umax=1.0)
    for tf, Tramp in ((10.0, 2.0), (7.3, 2.5)):
        r1, r2 = np.random.default_rng(4), np.random.default_rng(4)
        for _ in range(3):
            (t1, u1), (t2, u2) = arm.ramp_and_hold(r1, tf, Tramp), \
                jarm.ramp_and_hold(r2, tf, Tramp)
            assert np.array_equal(t1, t2) and np.array_equal(u1, u2)
            assert np.abs(u1).max() <= 1.0


PLANTS = {"rk4": dict(integrator="rk4", substeps=200),
          "rk45": dict(integrator="rk45"),
          "stage": dict(jac_mode="stage")}


@pytest.mark.parametrize("plant", list(PLANTS))
def test_step_matches_jax_simulate_ts(plant):
    """``Arm.step`` (lanes-minor, the closed-form RHS) over 5 periods of
    4 lanes against JAX ``simulate_Ts`` under ``vmap`` (its autodiff
    RHS), 1e-10; ``simulate_Ts`` of one lane is the same step."""
    kw = dict(BASE, **PLANTS[plant])
    jarm, arm = _pair(**kw)
    X, U, W = _lanes(3, 4, seed=11)
    X[:, :3] *= 0.7
    step = jax.jit(jax.vmap(lambda x, u, w: jarm.simulate_Ts(x, u, w)))
    xj = jnp.asarray(X)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a.T))
    xt = t(X)
    for _ in range(5):
        xj = step(xj, jnp.asarray(U), jnp.asarray(W))
        xt = arm.step(xt, t(U), t(W))
    assert np.isfinite(np.asarray(xj)).all()
    np.testing.assert_allclose(xt.numpy().T, np.asarray(xj), rtol=0,
                               atol=1e-10)
    one = arm.simulate_Ts(torch.from_numpy(X[1]), U[1], W[1])
    np.testing.assert_array_equal(one.numpy(),
                                  arm.step(t(X), t(U), t(W)).numpy()[:, 1])


def test_simulate_rampNhold_matches_jax():
    """``simulate_rampNhold`` (one trial, ``simulate``) and
    ``simulate_rampNhold_batch`` on a small loaded arm: the same schema,
    u and t bitwise, x and y within 1e-10 of JAX's."""
    kw = dict(Nmods=2, nlinks=1, L=0.75, m=0.3, output_type="markers",
              substeps=5)
    jarm, arm = _pair(**kw)
    one = arm.simulate_rampNhold(np.random.default_rng(2), 1.0, 0.5,
                                 w=np.array([0.2, 0.1]))
    ref = jarm.simulate_rampNhold(np.random.default_rng(2), 1.0, 0.5,
                                  w=np.array([0.2, 0.1]))
    W = np.array([[0.0, 0.0], [0.5, -0.3], [1.0, 0.4]])
    batch = arm.simulate_rampNhold_batch(np.random.default_rng(3), 1.0, 0.5,
                                         W)
    jbatch = jarm.simulate_rampNhold_batch(np.random.default_rng(3), 1.0,
                                           0.5, W)
    for mine, theirs in [(one, ref)] + list(zip(batch, jbatch)):
        assert set(mine) == set(theirs)
        for k in mine:
            assert mine[k].shape == np.asarray(theirs[k]).shape, k
        for k in ("t", "u", "w"):
            assert np.array_equal(mine[k], np.asarray(theirs[k])), k
        for k in ("x", "alpha", "alphadot", "y"):
            np.testing.assert_allclose(mine[k], np.asarray(theirs[k]),
                                       rtol=0, atol=1e-10, err_msg=k)
    assert batch[0]["x"].shape == (21, 4) and batch[0]["y"].shape == (21, 4)


@pytest.mark.parametrize("bad", [dict(integrator="euler"),
                                 dict(jac_mode="newton"),
                                 dict(output_type="torque")])
def test_unknown_names_raise(bad):
    with pytest.raises(ValueError):
        Arm(ArmConfig(**BASE, **bad), device="cpu")


def test_rhs_lanes_launches_fewer_operations():
    """``rhs_lanes`` (stacked) computes the same RHS as ``rhs_soa`` (rows)
    in fewer device operations (views aside; measured 61 against 143
    for the 3-link arm, held to half of them): the integrators that
    evaluate it hundreds of times a period are launch-bound on the
    card."""
    from torch.utils._python_dispatch import TorchDispatchMode

    views = {"select", "slice", "unsqueeze", "expand", "view", "alias",
             "transpose", "permute", "t", "squeeze", "as_strided",
             "_unsafe_view", "unbind", "detach"}

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func._schema.name.split("::")[1] not in views:
                Count.n += 1
            return func(*args, **(kwargs or {}))

    arm = Arm(ArmConfig(**BASE), device="cpu")
    X, U, W = (torch.from_numpy(np.ascontiguousarray(a.T))
               for a in _lanes(3, 16, seed=1))
    counts = []
    for fn in (lambda: arm.lane_rhs(U, W)(X),
               lambda: rhs_soa(arm.cfg, arm.G_host, arm.b_host, list(X[:3]),
                               list(X[3:]), list(U), W[0], W[1])):
        Count.n = 0
        with Count():
            fn()
        counts.append(Count.n)
    assert 2 * counts[0] <= counts[1], counts


class _Replay:
    """A stand-in for a captured ``torch.cuda.CUDAGraph`` on the CPU: the
    capture runs the function once and keeps its output as the static
    output buffer; ``replay`` runs it again into that buffer."""

    def __init__(self, fn):
        self.fn = fn
        self.out = fn()

    def replay(self):
        new = self.fn()
        if new is not None:
            self.out.copy_(new)


def _fake_capture(fn, warmup, device):
    g = _Replay(fn)
    return g, g.out


@pytest.mark.parametrize("plant", list(PLANTS))
def test_graphed_period_logic_is_the_eager_step(plant, monkeypatch):
    """``PlantGraph`` and ``RK45Graph`` with their capture replaced by a
    replay of the same function on the CPU: over three periods of new
    inputs and loads (the static buffers refilled each call) each is
    bitwise ``step_eager``; 'rk45' replays chunks until no lane is active.
    (On the card the captured graph runs the same kernels:
    chip_smoke.py phase GN4.)"""
    from koopman_realizations_torch.models import arm as A

    monkeypatch.setattr(A, "_capture", _fake_capture)
    arm = Arm(ArmConfig(**BASE, **PLANTS[plant]), device="cpu")
    cls = A.RK45Graph if plant == "rk45" else A.PlantGraph
    graph = cls(arm, 4, torch.float64, torch.device("cpu"))
    rng = np.random.default_rng(13)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    x = t(_lanes(3, 4, seed=12)[0].T)
    for k in range(3):
        U = t(rng.uniform(-0.6, 0.6, (3, 4)))
        W = t(np.stack([rng.uniform(0, 0.5, 4), rng.uniform(-0.3, 0.3, 4)]))
        xg = graph(x, U, W)
        xe = arm.step_eager(x, U, W)
        assert torch.equal(xg, xe), (plant, k)
        x = xe
    if plant == "rk45":
        assert graph.replays >= 3 * 125 // A.RK45_CHUNK - 3
