"""The port's continuous-time models against the JAX package on the CPU:
``logm_host``, ``zoh_discretize`` and ``zoh_step_bilinear`` against scipy
and JAX on the same f64 matrices, the continuous training (the generator
logm(K' + 1e-12 I) / Ts of the fitted operator) on the committed corpus
against the JAX ``Ksysid``, the ZOH and RK4 rollouts, and the checkpoint
round trip.  JAX runs in its x64 session.

Tolerances, each with what it was measured at:
- ``logm_host``, ``zoh_discretize`` and the exact bilinear step against
  scipy / JAX on the same f64 K: 1e-12 relative to the matrix's largest
  entry (the same LAPACK calls, or expm by another Pade code; measured
  <= 2e-15);
- the 3-step rollouts of one continuous model of each type in f64 against
  JAX's on the same arrays (the poorly fitted bilinear generator
  amplifies a difference ~60-fold a step under RK4: the two summation
  orders part by 5e-15 after one step, 2e-11 after three, 1e-8 after
  five): 1e-10 relative to the trajectory's scale (RK4 /
  expm in another summation order);
- continuous training against JAX's on the same corpus in scaled one-step
  prediction (one sample of each model's validation stepper): 1e-5 -- the
  generator is ill-conditioned where the fit is poor, and logm of two f32
  fits that differ in their last bits (the f32 lift and extraction) moves
  by ~1e2 times more than K; measured 3e-7 (linear poly-1) and 2e-6
  (bilinear poly-2).  The logm itself is compared on the same K above.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
import torch

from koopman_realizations_tpu.config import SysidConfig as JSysidConfig
from koopman_realizations_tpu.models import koopman as JK
from koopman_realizations_tpu.models.edmd import Ksysid as JKsysid
from koopman_realizations_tpu.ops.linalg import logm_host as jax_logm_host
from koopman_realizations_tpu.utils.checkpoint import (
    save_model as jax_save_model,
)
from koopman_realizations_torch.config import SysidConfig
from koopman_realizations_torch.models import koopman as TK
from koopman_realizations_torch.models.edmd import Ksysid
from koopman_realizations_torch.ops.linalg import logm_host
from koopman_realizations_torch.utils.checkpoint import load_model
from koopman_realizations_torch.utils.data import load_corpus
from koopman_realizations_torch.utils.metrics import one_step_predictions

from test_torch_oracle import (
    dict_sysid,
    jax_dataset,
    one_thread,  # noqa: F401  (fixture)
)

pytestmark = pytest.mark.usefixtures("one_thread")

CONTINUOUS = ("cont-linear", "cont-bilinear")


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


@functools.lru_cache(maxsize=None)
def trained(name):
    """(port Ksysid on the CPU, JAX Ksysid) of a continuous recipe, on
    the first 4 training trials of the corpus (all validation trials)."""
    ds = load_corpus()
    ds = ds.__class__(train=ds.train[:4], val=ds.val, params=ds.params)
    port = Ksysid(ds, SysidConfig(**dict_sysid(name)), device="cpu")
    jks = JKsysid(jax_dataset(ds), JSysidConfig(**dict_sysid(name)))
    return port.train_models(), jks.train_models()


def test_logm_host_matches_scipy_on_the_same_k():
    _, jks = trained("cont-linear")
    K = np.asarray(jks.model.K, np.float64).T + 1e-12 * np.eye(
        jks.model.K.shape[0])
    L = logm_host(K)
    assert L.dtype == np.float64
    assert rel(L, np.real(scipy.linalg.logm(K))) < 1e-12
    assert rel(L, jax_logm_host(K)) < 1e-12
    assert rel(scipy.linalg.expm(L), K) < 1e-9


def test_zoh_discretize_matches_scipy():
    rng = np.random.default_rng(0)
    A = rng.standard_normal((7, 7)) - 2 * np.eye(7)
    B = rng.standard_normal((7, 3))
    Ts = 0.05
    Ad, Bd = TK.zoh_discretize(A, B, Ts)
    aug = np.zeros((10, 10))
    aug[:7, :7], aug[:7, 7:] = A * Ts, B * Ts
    E = scipy.linalg.expm(aug)
    assert rel(Ad, E[:7, :7]) < 1e-12 and rel(Bd, E[:7, 7:]) < 1e-12
    Jd, Jb = JK.zoh_discretize(jnp.asarray(A), jnp.asarray(B), Ts)
    assert rel(Ad, Jd) < 1e-12 and rel(Bd, Jb) < 1e-12


def test_zoh_step_bilinear_matches_jax():
    _, jks = trained("cont-bilinear")
    jm = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                jks.model)
    tm = TK.BilinearModel(A=np.asarray(jm.A), B=np.asarray(jm.B),
                          C=np.asarray(jm.C), meta=jks.model.meta,
                          basis=None)
    rng = np.random.default_rng(1)
    NL, m = tm.A.shape[0], tm.B.shape[1]
    z, u = rng.standard_normal((NL, 3)), rng.uniform(-1, 1, (m, 3))
    got = TK.zoh_step_bilinear(tm, device="cpu")(torch.from_numpy(z),
                                                torch.from_numpy(u))
    jstep = JK.zoh_step_bilinear(jm)
    for b in range(3):
        assert rel(got[:, b].numpy(),
                   jstep(jnp.asarray(z[:, b]), jnp.asarray(u[:, b]))) < 1e-12


def _as64(model):
    """A JAX model's arrays in f64 (both packages' rollouts in f64)."""
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                  model)


@pytest.mark.parametrize("name,stepper", [
    ("cont-linear", "rk4"), ("cont-bilinear", "rk4"),
    ("cont-bilinear", "zoh"), ("cont-nonlinear", "rk4")])
def test_continuous_rollouts_match_jax(name, stepper):
    if name == "cont-nonlinear":
        _, jb = trained("cont-bilinear")
        # the nonlinear vector field of the bilinear recipe's corpus: its
        # generator's first nzeta columns over the lift of [zeta; u]
        cfg = dict(dict_sysid("cont-bilinear"), model_type="nonlinear",
                   obs_degree=(1,))
        ds = load_corpus()
        ds = ds.__class__(train=ds.train[:4], val=ds.val, params=ds.params)
        jks = JKsysid(jax_dataset(ds), JSysidConfig(**cfg)).train_models()
    else:
        jks = trained(name)[1]
    jm = _as64(jks.model)
    cls = {"LinearModel": TK.LinearModel, "BilinearModel": TK.BilinearModel,
           "NonlinearModel": TK.NonlinearModel}[type(jm).__name__]
    tm = TK.from_jax_arrays(
        {"meta": jks.model.meta.__dict__, "basis": {
            "model_type": jm.basis.model_type, "n": jm.basis.n,
            "m": jm.basis.m, "nd": jm.basis.nd, "nw": jm.basis.nw,
            "families": [list(f) for f in jm.basis.families]}},
        {k: np.asarray(getattr(jm, k)) for k in ("A", "B", "C", "W")
         if hasattr(jm, k)})[0]
    assert isinstance(tm, cls) and tm.meta.time_type == "continuous"
    tr = jks.valdata[0]
    T = 3
    U = np.asarray(tr.u, np.float64)[:T]
    zeta0 = np.asarray(tr.y, np.float64)[0]
    if cls is TK.NonlinearModel:
        init = zeta0
    else:
        init = np.asarray(jm.basis.lift(jnp.asarray(zeta0)))
    if cls is TK.BilinearModel:
        Yj, Zj = JK.rollout_bilinear(jm, jnp.asarray(init), jnp.asarray(U),
                                     continuous_stepper=stepper)
    else:
        Yj, Zj = JK.rollout(jm, jnp.asarray(init), jnp.asarray(U))
    Yt, Zt = TK.rollout(tm, torch.from_numpy(init), torch.from_numpy(U),
                        continuous_stepper=stepper)
    assert np.isfinite(np.asarray(Zj)).all()
    assert rel(Zt.numpy(), Zj) < 1e-10 and rel(Yt.numpy(), Yj) < 1e-10


@pytest.mark.parametrize("name", CONTINUOUS)
def test_continuous_training_matches_jax(name):
    port, jks = trained(name)
    assert port.model.meta.time_type == "continuous"
    assert dataclasses.asdict(port.model.meta) \
        == dataclasses.asdict(jks.model.meta)
    tm = load_model_of(jks)
    d = np.abs(one_step_predictions(port.model, port.valdata, "cpu")
               - one_step_predictions(tm, port.valdata, "cpu")).max()
    assert d < 1e-5, d


_saved = {}


def load_model_of(jks):
    """The JAX-trained model through JAX's save_model and the port's
    load_model (continuous models load)."""
    import tempfile
    key = id(jks)
    if key not in _saved:
        d = tempfile.mkdtemp()
        path = jax_save_model(f"{d}/m", jks.model, jks.scaler)
        _saved[key] = load_model(path)[0]
    return _saved[key]


def test_continuous_checkpoint_round_trip():
    _, jks = trained("cont-bilinear")
    tm = load_model_of(jks)
    assert tm.meta.time_type == "continuous"
    np.testing.assert_array_equal(tm.A, np.asarray(jks.model.A))
    np.testing.assert_array_equal(tm.B, np.asarray(jks.model.B))
