"""The port's random-system ensemble and model-class sweep
(``ops/integrators.py``, ``models/rsys.py``, ``workflows/rand_models.py``,
``device="cpu"``, f64) against the JAX package on the same seeded
inputs, JAX in its x64 session as ``tests/conftest.py`` sets.

Tolerances, each with what it was measured at:
- ``rk4`` on a scalar ODE: rtol 1e-12 (measured 0);
- ``construct_systems`` and ``generate_input_steps``: bitwise (the same
  numpy draws in the same order);
- the vector field at negative, zero and positive states and inputs
  (float exponents, 0 ** 0): rtol 1e-13 (measured 1.5e-16);
- ``simulate_systems``: rtol 1e-10 (measured 1.2e-13);
- ``_fit_and_val`` of each family at degrees 1-3: rtol 1e-6, atol 1e-9,
  the JAX pin's tolerances (``tests/test_rsys.py:104``; measured <=
  3.3e-11 relative);
- ``evaluate_rand_models`` at ``tests/test_rsys.py:92-100``'s sizes: the
  kept masks equal, errors and medians rtol 1e-6 (measured 7.0e-13);
- the port's ``_pin_to_production`` against the port's own ``Ksysid``:
  rtol 1e-6, atol 1e-9 as in the JAX package (measured 6.2e-7: the
  trainer's min-norm SVD solve against the batched path's ridge Gram
  solve).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from koopman_realizations_tpu.models import rsys as jrsys
from koopman_realizations_tpu.ops.integrators import rk4 as jrk4
from koopman_realizations_tpu.workflows import rand_models as jrm
from koopman_realizations_torch.models import rsys
from koopman_realizations_torch.ops.integrators import rk4
from koopman_realizations_torch.workflows import evaluate_rand_models
from koopman_realizations_torch.workflows import rand_models as trm

from test_torch_oracle import one_thread  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("one_thread")


def test_rk4_scalar_ode_matches_jax():
    f = lambda x: -0.7 * x + torch.sin(x)
    jf = lambda x: -0.7 * x + jnp.sin(x)
    x0 = np.array([0.3, -1.2, 2.5])
    got = rk4(f, torch.from_numpy(x0), 0.05, 8).numpy()
    ref = np.asarray(jrk4(jf, jnp.asarray(x0), 0.05, 8))
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=0)
    # dx/dt = -x: four RK4 steps of 0.25 against exp(-1)
    y = rk4(lambda x: -x, torch.ones(1, dtype=torch.float64), 1.0, 4)
    assert abs(y.item() - np.exp(-1.0)) < 1e-4


def test_construct_systems_and_inputs_are_bitwise_jax():
    a, b = np.random.default_rng(7), np.random.default_rng(7)
    ens = rsys.construct_systems(9, 5, 3, 2, a)
    jens = jrsys.construct_systems(9, 5, 3, 2, b)
    for f in ("coeffs", "px", "pu", "cu"):
        np.testing.assert_array_equal(getattr(ens, f), getattr(jens, f))
    np.testing.assert_array_equal(rsys.generate_input_steps(a, 201),
                                  jrsys.generate_input_steps(b, 201))
    u = rsys.generate_input_steps(a, 201, num_steps=50)
    assert np.all(u[200:] == 0.0) and len(np.unique(u)) <= 6


def test_vector_field_matches_jax_at_negative_states():
    ens = rsys.construct_systems(4, 5, 3, 1, np.random.default_rng(2))
    xs = np.array([-1.7, -0.4, 0.0, 0.0, 0.9, 2.2])
    us = np.array([-0.8, 0.0, -0.5, 0.0, 0.6, -1.0])
    for s in range(ens.num_sys):
        got = ens.vf(s, xs, us, device="cpu").numpy()
        ref = np.asarray(jax.vmap(lambda x, u: jrsys.RsysEnsemble(
            ens.coeffs, ens.px, ens.pu, ens.cu).vf(s, x, u))(
                jnp.asarray(xs), jnp.asarray(us)))
        np.testing.assert_allclose(got, ref, rtol=1e-13, atol=1e-15)
        assert np.isfinite(got).all()


@functools.lru_cache(maxsize=None)
def ensembles(num_sys: int, num_trials: int, seed: int = 0):
    """(port datasets, JAX datasets) of one seeded ensemble, t_end 25."""
    out = []
    for mod in (rsys, jrsys):
        rng = np.random.default_rng(seed)
        ens = mod.construct_systems(num_sys, 5, 3, 1, rng)
        kw = {"device": "cpu"} if mod is rsys else {}
        out.append(mod.simulate_systems(ens, 25.0, 0.05, num_trials, rng,
                                        **kw))
    return tuple(out)


def test_simulate_systems_matches_jax():
    port, jx = ensembles(3, 4)
    assert len(port) == 3 and len(port[0].train) == 3
    assert len(port[0].val) == 1
    for p, j in zip(port, jx):
        for tp, tj in zip(p.train + p.val, j.train + j.val):
            np.testing.assert_array_equal(tp.u, tj.u)
            np.testing.assert_array_equal(tp.t, tj.t)
            np.testing.assert_allclose(tp.y, np.asarray(tj.y), rtol=1e-10,
                                       atol=1e-13)
    assert port[0].train[0].y.shape == (501, 1)
    if not torch.cuda.is_available():      # the default device is the card
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            rsys.simulate_systems(rsys.construct_systems(
                1, 2, 1, 1, np.random.default_rng(0)), 1.0, 0.5, 2,
                np.random.default_rng(0))


def scaled_args(datasets):
    Ytr, Utr, Yval, Uval = trm._stack_ensemble(datasets)
    y_fac, y_off, u_fac, u_off = trm._scale_params(Ytr, Utr)
    return [(Ytr - y_off[:, None, None]) / y_fac[:, None, None],
            (Utr - u_off[:, None, None]) / u_fac[:, None, None],
            (Yval - y_off[:, None]) / y_fac[:, None],
            (Uval - u_off[:, None]) / u_fac[:, None]]


@pytest.mark.parametrize("family", ["linear", "bilinear", "nonlinear"])
def test_fit_and_val_matches_jax(family):
    port, _ = ensembles(3, 4)
    args = scaled_args(port)
    for degree in (1, 2, 3):
        lasso = 4.0 if family == "nonlinear" else np.inf
        got = trm._fit_and_val(*[torch.from_numpy(a) for a in args],
                               degree=degree, family=family, lasso=lasso,
                               lasso_iters=300).numpy()
        ref = np.asarray(jrm._fit_and_val(*[jnp.asarray(a) for a in args],
                                          degree=degree, family=family,
                                          lasso=lasso, lasso_iters=300))
        assert np.isfinite(ref).all()
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-9)


def test_evaluate_rand_models_matches_jax():
    """``tests/test_rsys.py:92-100``'s sizes: 6 systems, 6 trials,
    degrees 4 / 2 / 2, 300 FISTA iterations."""
    port, jx = ensembles(6, 6)
    kw = dict(max_degree_linear=4, max_degree_bilinear=2,
              max_degree_nonlinear=2, lasso_iters=300)
    got = evaluate_rand_models(port, device="cpu", **kw)
    ref = jrm.evaluate_rand_models(jx, **kw)
    for fam in ("linear", "bilinear", "nonlinear"):
        g, r = got[fam], ref[fam]
        np.testing.assert_array_equal(g["dims"], r["dims"])
        keep_g = np.all(np.isfinite(g["err"]), 0) & np.all(g["err"] < 10, 0)
        keep_r = np.all(np.isfinite(r["err"]), 0) & np.all(r["err"] < 10, 0)
        np.testing.assert_array_equal(keep_g, keep_r)
        assert g["kept"] == r["kept"]
        np.testing.assert_allclose(g["err"][:, keep_g], r["err"][:, keep_r],
                                   rtol=1e-6, atol=1e-9)
        np.testing.assert_allclose(g["median"], r["median"], rtol=1e-6)
    assert np.isfinite(got["linear"]["median"]).all()
    assert got["linear"]["median"][-1] < 1.0
    with pytest.raises(NotImplementedError, match="item 9"):
        evaluate_rand_models(port, mesh=object(), device="cpu")


def _pin_to_production(datasets, rtol=1e-6, atol=1e-9):
    """The JAX package's pin (``tests/test_rsys.py:103-148``) on the port:
    the batched ``_fit_and_val`` against per-system fits of the port's own
    ``Ksysid`` and their validation rollouts."""
    from koopman_realizations_torch.config import SysidConfig
    from koopman_realizations_torch.models.edmd import Ksysid

    args = [torch.from_numpy(a) for a in scaled_args(datasets)]
    for family, degree in (("linear", 3), ("bilinear", 2),
                           ("nonlinear", 2)):
        err_batched = trm._fit_and_val(*args, degree=degree,
                                       family=family).numpy()
        err_prod = []
        for ds in datasets:
            ks = Ksysid(ds, SysidConfig(model_type=family,
                                        obs_type=("poly",),
                                        obs_degree=(degree,)),
                        device="cpu").train_models()
            res = ks.val_model(ks.model, ks.valdata[0])
            ysim = np.asarray(res["sim"]["y"])[:, 0]
            yreal = np.asarray(res["real"]["y"])[:, 0]
            err_prod.append(np.mean(np.abs(ysim - yreal))
                            / np.mean(np.abs(yreal)))
        np.testing.assert_allclose(err_batched, np.asarray(err_prod),
                                   rtol=rtol, atol=atol,
                                   err_msg=f"{family} {degree}")


def test_rand_models_pin_to_the_ports_trainer():
    port, _ = ensembles(3, 5, seed=1)
    _pin_to_production(port)
