"""The port's LASSO path (``ops/lasso.py``, ``ops/lstsq.py:gram_lstsq``
and the finite-lasso ``Ksysid``, ``device="cpu"``) against the JAX
package on the same seeded inputs, JAX in its x64 session as
``tests/conftest.py`` sets.

Tolerances, each with what it was measured at:
- ``project_l1_ball``, one ball and a batch of balls (inside the ball,
  on it, a zero and a negative budget): atol 1e-12 (measured 1.1e-16);
- ``lasso_constrained_lstsq`` (fixed iterations), with and without a pin
  mask, one system and a batch: rtol 1e-9 (measured <= 1.0e-15 of
  max |K|);
- the trainer's route with ``tol`` against the JAX host mirror on
  ``tests/test_edmd.py``'s problem: the same stop iteration (200), K
  rtol 1e-9 (measured <= 2.3e-16 of max |K|);
- three budgets in one batched run (the trainer's route for a lasso
  vector): each stops where the JAX mirror stops alone (200), K rtol 1e-9
  (measured <= 2.6e-16 of max |K|);
- the converged fit's objective against the JAX certification oracle
  ``lasso_oracle_constrained`` on a 10 x 6 problem: 1e-8 relative
  (measured 2.1e-13; the weak-duality gap 3.7e-16);
- ``_delay_pin_mask`` equal to JAX's (nd = 1, 2);
- ``gram_lstsq`` batched: rtol 1e-10 (measured 2.5e-16 of max |X|);
- ``Ksysid`` at lasso (8, inf) on the committed corpus (bilinear, the
  asset recipe, ``lasso_iters=300``), the port's PCA signs aligned to
  JAX's: in f64 the one-step predictions of both candidates within 1e-5,
  the asset retrain's bound (measured 5.7e-11 and 6.2e-15); in f32 the
  least-squares candidate's (measured 8.9e-8) and the lasso candidate's
  K against the JAX host mirror run on the port's own regression
  matrices, 1e-6 of max |K| (measured 9.0e-9 relative).
"""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from koopman_realizations_tpu.config import SysidConfig as JSysidConfig
from koopman_realizations_tpu.models.edmd import Ksysid as JKsysid
from koopman_realizations_tpu.ops import lasso as jlasso
from koopman_realizations_tpu.ops import lstsq as jlstsq
from koopman_realizations_torch.config import SysidConfig
from koopman_realizations_torch.models.edmd import Ksysid
from koopman_realizations_torch.ops.lasso import (
    lasso_constrained_lstsq,
    lasso_fista_f64,
    project_l1_ball,
)
from koopman_realizations_torch.ops.lstsq import gram_lstsq, ridge_for_dtype
from koopman_realizations_torch.types import DataSet
from koopman_realizations_torch.utils.metrics import one_step_predictions

from test_torch_edmd import cfg_kw, corpus, jax_dataset
from test_torch_oracle import one_thread  # noqa: F401  (fixture)
from test_torch_oracle import one_step_predictions as jax_one_step

pytestmark = pytest.mark.usefixtures("one_thread")

T = lambda a: torch.from_numpy(np.asarray(a, np.float64))


def _balls():
    rng = np.random.default_rng(3)
    v = rng.standard_normal((6, 17))
    v[2, 5:9] = v[2, 4]                     # ties in the sort
    v[3] = 0.0
    l1 = np.abs(v).sum(1)
    t = np.array([0.3 * l1[0], 2.0 * l1[1], 1.5, 0.0, -0.7, l1[5]])
    return v, t


@pytest.mark.parametrize("row", range(6))
def test_project_l1_ball_one_ball_matches_jax(row):
    v, t = _balls()
    got = project_l1_ball(T(v[row]), float(t[row])).numpy()
    ref = np.asarray(jlasso.project_l1_ball(jnp.asarray(v[row]), t[row]))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12)
    if row == 1:                            # inside: unchanged
        np.testing.assert_array_equal(got, v[row])
    if row in (3, 4) and t[row] < 0:        # negative budget: 0
        np.testing.assert_array_equal(got, 0.0)


def test_project_l1_ball_batched_matches_jax():
    import jax
    v, t = _balls()
    got = project_l1_ball(T(v), T(t)).numpy()
    ref = np.asarray(jax.vmap(jlasso.project_l1_ball)(jnp.asarray(v),
                                                      jnp.asarray(t)))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12)
    l1 = np.abs(got).sum(1)
    assert np.all(l1[[0, 2]] <= t[[0, 2]] * (1 + 1e-12))


def _problem(rng, rows=120, cols=9):
    return rng.standard_normal((rows, cols)), rng.standard_normal((rows,
                                                                   cols))


@pytest.mark.parametrize("pinned", [False, True])
def test_fixed_iteration_fista_matches_jax(pinned):
    rng = np.random.default_rng(0)
    A, B = _problem(rng)
    pin = None
    if pinned:
        pin = np.zeros((9, 9), bool)
        pin[0, 0] = pin[3, 5] = True
    t = 6.0 if pinned else 4.0
    got = lasso_constrained_lstsq(T(A), T(B), t, pin_mask=pin,
                                  iters=800).numpy()
    ref = np.asarray(jlasso.lasso_constrained_lstsq(A, B, t, pin_mask=pin,
                                                    iters=800))
    np.testing.assert_allclose(got, ref, rtol=1e-9, atol=1e-12)
    if pinned:
        assert got[0, 0] == got[3, 5] == 1.0


def test_batched_fista_matches_jax_per_system():
    rng = np.random.default_rng(1)
    probs = [_problem(rng, 60, 5) for _ in range(3)]
    ts = np.array([1.0, 2.5, 4.0])
    got = lasso_constrained_lstsq(T(np.stack([p[0] for p in probs])),
                                  T(np.stack([p[1] for p in probs])),
                                  T(ts), iters=800).numpy()
    for s, (A, B) in enumerate(probs):
        ref = np.asarray(jlasso.lasso_constrained_lstsq(A, B, ts[s],
                                                        iters=800))
        np.testing.assert_allclose(got[s], ref, rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("pinned", [False, True])
def test_trainer_route_with_tol_matches_jax_mirror(pinned):
    """``tests/test_edmd.py:130-150``'s problem through the trainer's
    route (f64, ``tol`` checked every 100 iterations) and the JAX host
    mirror: both stop at the same check and agree."""
    rng = np.random.default_rng(0)
    A, B = rng.standard_normal((120, 9)), rng.standard_normal((120, 9))
    pin = None
    if pinned:
        pin = np.zeros((9, 9), bool)
        pin[0, 0] = True
    t = 6.0 if pinned else 4.0
    res = lasso_fista_f64(T(A), T(B), t, pin_mask=pin, iters=50000,
                          tol=1e-12)
    ref = jlasso.lasso_constrained_lstsq_f64(A, B, t, pin_mask=pin,
                                             iters=50000, tol=1e-12)
    assert 100 <= res.iters < 50000 and res.iters % 100 == 0
    np.testing.assert_allclose(res.K.numpy(), ref, rtol=1e-9, atol=1e-12)
    obj = float(((A @ ref - B) ** 2).sum())
    assert abs(res.objective - obj) <= 1e-10 * obj
    K = lasso_fista_f64(T(A), T(B), t, pin_mask=pin, iters=res.iters).K
    np.testing.assert_array_equal(K.numpy(), res.K.numpy())


def test_batched_budgets_stop_each_as_alone():
    """Three budgets on one problem in one batched run (the trainer's
    route for a lasso vector): each stops at the check the JAX host
    mirror stops at alone, with its K."""
    rng = np.random.default_rng(0)
    A, B = rng.standard_normal((120, 9)), rng.standard_normal((120, 9))
    ts = (2.0, 4.0, 6.0)
    res = lasso_fista_f64(T(A), T(B), ts, iters=50000, tol=1e-12)
    assert res.K.shape == (3, 9, 9) and res.iters.shape == (3,)
    for i, t in enumerate(ts):
        alone = lasso_fista_f64(T(A), T(B), t, iters=50000, tol=1e-12)
        ref = jlasso.lasso_constrained_lstsq_f64(A, B, t, iters=50000,
                                                 tol=1e-12)
        assert res.iters[i] == alone.iters
        np.testing.assert_allclose(res.K[i].numpy(), ref, rtol=1e-9,
                                   atol=1e-12)
        assert abs(res.objective[i] - alone.objective) \
            <= 1e-12 * alone.objective
        assert res.ms[i] >= 0.0


def test_converged_objective_matches_jax_oracle():
    """A 10 x 6 problem whose budget binds: the converged FISTA objective
    against the JAX coordinate-descent oracle's (weak-duality bound
    included)."""
    rng = np.random.default_rng(5)
    Px, Py = rng.standard_normal((10, 6)), rng.standard_normal((10, 6))
    K_ls = np.linalg.lstsq(Px, Py, rcond=None)[0]
    budget = 0.5 * np.abs(K_ls).sum()
    res = lasso_fista_f64(T(Px), T(Py), budget, iters=200000, tol=1e-15)
    K_f = res.K.numpy()
    assert np.abs(K_f).sum() <= budget * (1 + 1e-12)
    G, H = Px.T @ Px, Px.T @ Py
    g = 2.0 * (G @ K_f - H)
    nz = np.abs(K_f) > 1e-9
    mu_hat = float(np.median(-g[nz] * np.sign(K_f[nz])))
    K_o, mu = jlasso.lasso_oracle_constrained(
        G, H, budget, mu_hat / 2, mu_hat * 2, K_f, bisect_steps=40,
        cd_tol=1e-14)
    obj = lambda K: float(((Px @ K - Py) ** 2).sum())
    assert abs(obj(K_f) - obj(K_o)) <= 1e-8 * obj(K_o)
    lower = obj(K_o) + mu * (np.abs(K_o).sum() - budget)
    assert (obj(K_f) - lower) <= 1e-8 * obj(K_f)


def test_gram_lstsq_matches_jax_batched():
    rng = np.random.default_rng(2)
    A = rng.standard_normal((4, 50, 7))
    Bm = rng.standard_normal((4, 50, 3))
    AtA, AtB = np.swapaxes(A, 1, 2) @ A, np.swapaxes(A, 1, 2) @ Bm
    got = gram_lstsq(T(AtA), T(AtB), ridge=ridge_for_dtype(torch.float64))
    for s in range(4):
        ref = np.asarray(jlstsq.gram_lstsq(AtA[s], AtB[s], ridge=1e-12))
        np.testing.assert_allclose(got[s].numpy(), ref, rtol=1e-10,
                                   atol=1e-13)
    assert ridge_for_dtype(torch.float32) == jlstsq.ridge_for_dtype(
        jnp.float32) == 1e-6
    with pytest.raises(NotImplementedError, match="item 9"):
        gram_lstsq(T(AtA), T(AtB), psum_axis="data")


@pytest.mark.parametrize("nd", [1, 2])
def test_delay_pin_mask_matches_jax(nd):
    full = corpus()
    ds = DataSet(train=full.train[:1], val=full.val[:1], params=full.params)
    kw = dict(model_type="linear", obs_type=("poly",), obs_degree=(2,),
              delays=nd)
    port = Ksysid(ds, SysidConfig(**kw), device="cpu")
    jks = JKsysid(jax_dataset(ds), JSysidConfig(**kw))
    Nm = port.lift_snapshot_matrices()[0].shape[1]
    assert Nm == np.asarray(jks.lift_snapshot_matrices()[0]).shape[1]
    mask = port._delay_pin_mask(Nm)
    np.testing.assert_array_equal(mask, jks._delay_pin_mask(Nm))
    assert mask.sum() == nd * (port.n + port.m)
    bil = Ksysid(ds, SysidConfig(**dict(kw, model_type="bilinear")),
                 device="cpu")
    assert bil._delay_pin_mask(Nm) is None


def test_linear_lasso_with_delays_pins_the_shift_entries():
    """A linear model with one delay at a finite lasso: the pinned
    entries of K are 1, the free L1 norm within its budget, and the
    candidate's one-step predictions the JAX trainer's."""
    full = corpus()
    ds = DataSet(train=full.train[:1], val=full.val[:1], params=full.params)
    kw = dict(model_type="linear", obs_type=("poly",), obs_degree=(2,),
              delays=1, lasso=(20.0,), lasso_iters=400)
    port = Ksysid(ds, SysidConfig(**kw), device="cpu").train_models()
    jks = JKsysid(jax_dataset(ds), JSysidConfig(**kw)).train_models()
    K = port.model.K
    mask = port._delay_pin_mask(K.shape[0])
    assert np.all(K[mask] == 1.0)
    st = port.lasso_stats[20.0]
    assert st["iters"] <= 400
    assert st["free_l1"] <= st["budget"] * (1 + 1e-12)
    np.testing.assert_allclose(K, np.asarray(jks.model.K), rtol=1e-6,
                               atol=1e-9)


@functools.lru_cache(maxsize=None)
def lasso_trained(dtype: str):
    """(port Ksysid on the CPU, JAX Ksysid), bilinear at the asset recipe
    in ``dtype`` with lasso (8, inf) and 300 FISTA iterations, the port's
    PCA components first given JAX's signs (as ``test_torch_edmd.py``
    aligns them: FISTA's power iteration starts from the ones vector, so
    its step, and with it an unconverged K, depends on the components'
    signs)."""
    kw = dict(cfg_kw("bilinear", lasso=(8.0, float("inf")),
                     lasso_iters=300), dtype=dtype)
    ds = corpus()
    jks = JKsysid(jax_dataset(ds), JSysidConfig(**kw)).train_models()
    port = Ksysid(ds, SysidConfig(**kw), device="cpu")
    J = np.asarray(jks.basis.pcs)
    port.basis = port.basis.with_pcs(
        port.basis.pcs * np.sign(np.sum(port.basis.pcs * J, axis=0)))
    return port.train_models(), jks


@pytest.mark.parametrize("cand", [0, 1])
def test_ksysid_lasso_candidates_match_jax_f64(cand):
    """f64 lift: both candidates' one-step predictions within 1e-5 of the
    JAX trainer's."""
    port, jks = lasso_trained("float64")
    assert [c.lasso for c in port.candidates] == [8.0, float("inf")]
    pm, jm = port.candidates[cand], jks.candidates[cand]
    assert dataclasses.asdict(pm.meta) == dataclasses.asdict(jm.meta)
    p = one_step_predictions(pm, port.valdata, "cpu")
    j = jax_one_step(jm, jks.valdata)
    assert np.abs(p - j).max() < 1e-5


def test_ksysid_lasso_f32_recipe():
    """The asset recipe (f32 lift): the least-squares candidate within
    1e-5 of the JAX trainer in one-step prediction; the lasso candidate's
    K equal to the JAX host mirror's run on this trainer's own regression
    matrices (the two packages' f32 PCA projections part by 5e-7 of the
    features' scale, which 300 unconverged FISTA iterations carry to
    ~1e-5 in prediction), its budget spent, its stats recorded."""
    port, jks = lasso_trained("float32")
    p = one_step_predictions(port.candidates[1], port.valdata, "cpu")
    j = jax_one_step(jks.candidates[1], jks.valdata)
    assert np.abs(p - j).max() < 1e-5
    Px, Py = (t.double().numpy() for t in port.lift_snapshot_matrices())
    st = port.lasso_stats[8.0]
    assert st["iters"] == 300 and st["budget"] == 8.0 * port.N
    ref = jlasso.lasso_constrained_lstsq_f64(Px, Py, st["budget"],
                                             iters=300, tol=1e-12)
    K = port.candidates[0].K
    assert K.dtype == np.float32
    np.testing.assert_allclose(K, ref.astype(np.float32), rtol=0,
                               atol=1e-6 * np.abs(ref).max())
    assert st["free_l1"] <= st["budget"] * (1 + 1e-12)
    assert abs(st["objective"] - float(((Px @ ref - Py) ** 2).sum())) \
        <= 1e-9 * st["objective"]
