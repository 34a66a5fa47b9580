"""The port's trainer (``models/edmd.py:Ksysid``, ``device="cpu"``) against
the JAX ``Ksysid`` on the same data: the committed corpus
(``assets/arm3_corpus.npz``) at the recipe of the three model assets
(poly-3, PCA at 99 % -- 99.99 % for the nonlinear model -- f32 lift, f64
regression), JAX in its x64 session as ``tests/conftest.py`` sets.

Tolerances, each with what it was measured at:
- scaler factors and offsets rtol 1e-12 (bitwise: the same numpy f64);
- snapshot pairs bitwise (the same numpy indexing);
- the full lift at f32 rtol 2.4e-7 (bitwise: the same IEEE products in
  the same order);
- the PCs after aligning each column's sign to JAX's, 1e-10 (measured
  <= 7.6e-14: two f64 SVDs of the same matrix);
- A, B/Beta, M, K, W after the same sign alignment of the econ basis,
  relative to each matrix's largest entry, 1e-4 (f32 model, f64 solves
  of f32 matrices that differ in the last bits of the PCA projection;
  measured <= 2.0e-5, the nonlinear K);
- scaled one-step predictions 1e-5 (the asset retrain's bound,
  ``test_torch_oracle.py:test_asset_provenance_retrain``; measured
  <= 1.2e-7);
- ``validate()`` euclid_mean of every validation trial rtol 1e-3 (1200-step
  open-loop f32 rollouts, measured <= 4.0e-5; NaN where the JAX rollout
  diverges too: the nonlinear model's on two of the five trials).
An f64 training on a 3-trial slice holds the one-step predictions to
1e-9.
"""

import dataclasses
import functools
import math

import jax
import numpy as np
import pytest
import torch

from koopman_realizations_tpu import types as jtypes
from koopman_realizations_tpu.config import SysidConfig as JSysidConfig
from koopman_realizations_tpu.models.edmd import Ksysid as JKsysid
from koopman_realizations_torch.config import ArmConfig, MpcConfig
from koopman_realizations_torch.config import SysidConfig
from koopman_realizations_torch.control.kmpc import BilinearKmpc
from koopman_realizations_torch.control.ksim import Ksim
from koopman_realizations_torch.models.arm import Arm
from koopman_realizations_torch.models.edmd import Ksysid
from koopman_realizations_torch.ops.linalg import pcs_for_explained
from koopman_realizations_torch.ops.lstsq import lstsq
from koopman_realizations_torch.ops.observables import delay_embed
from koopman_realizations_torch.ops.scaling import fit_scaler
from koopman_realizations_torch.types import DataSet, Trial, merge_trials
from koopman_realizations_torch.utils.checkpoint import load_model, save_model
from koopman_realizations_torch.utils.data import load_corpus
from koopman_realizations_torch.utils.metrics import one_step_predictions
from koopman_realizations_torch.utils.trajectories import blockM_reference

from test_torch_oracle import (
    BENCH_ARM,
    BENCH_MPC,
    PCA_EXPLAINED,
    bench_X0,
    jax_dataset,
    one_thread,  # noqa: F401  (fixture)
)
from test_torch_oracle import one_step_predictions as jax_one_step

pytestmark = pytest.mark.usefixtures("one_thread")

KINDS = ("bilinear", "linear", "nonlinear")
RECIPE = dict(obs_type=("poly",), obs_degree=(3,), dim_red=True,
              dtype="float32")


def cfg_kw(kind, **kw):
    return dict(RECIPE, model_type=kind, pca_explained=PCA_EXPLAINED[kind],
                **kw)


@functools.lru_cache(maxsize=None)
def corpus():
    return load_corpus()


@functools.lru_cache(maxsize=None)
def trained(kind):
    """(port Ksysid on the CPU, JAX Ksysid), both trained on the corpus."""
    ds = corpus()
    port = Ksysid(ds, SysidConfig(**cfg_kw(kind)), device="cpu")
    jks = JKsysid(jax_dataset(ds), JSysidConfig(**cfg_kw(kind)))
    return port.train_models(), jks.train_models()


def jax_predictions(jm, valdata):
    """JAX-side one-step predictions (the oracle's for linear/bilinear;
    (W^T g([zeta; u]))[:n] for the nonlinear model)."""
    if not hasattr(jm, "W"):
        return jax_one_step(jm, valdata)
    out = []
    for tr in valdata:
        zu = np.concatenate([np.asarray(tr.y, np.float64)[:-1],
                             np.asarray(tr.u, np.float64)[:-1]], axis=1)
        g = np.asarray(jax.vmap(jm.basis.lift)(zu), np.float64)
        out.append((g @ np.asarray(jm.W, np.float64))[:, :jm.meta.n])
    return np.concatenate(out)


def econ_signs(port, jks):
    """+-1 per entry of the econ basis [zeta; pcs^T g; 1] that maps the
    port's PCA components onto JAX's."""
    P, J = port.basis.pcs, np.asarray(jks.basis.pcs)
    s = np.sign(np.sum(P * J, axis=0))
    nz = port.basis.nzeta_aug
    return np.concatenate([np.ones(nz), s, np.ones(1)])


# ---------------------------------------------------- the three trainings


@pytest.mark.parametrize("kind", KINDS)
def test_scaler_and_snapshot_pairs_match_jax(kind):
    port, jks = trained(kind)
    for f in ("y_factor", "y_offset", "u_factor", "u_offset"):
        np.testing.assert_allclose(getattr(port.scaler, f),
                                   np.asarray(getattr(jks.scaler, f)),
                                   rtol=1e-12, atol=0)
    for f in ("alpha", "beta", "u"):
        np.testing.assert_array_equal(getattr(port.snapshot_pairs, f),
                                      np.asarray(getattr(jks.snapshot_pairs,
                                                         f)))
    assert port.snapshot_pairs.alpha.shape == (11999, 6)


@pytest.mark.parametrize("kind", KINDS)
def test_full_lift_and_pcs_match_jax(kind):
    port, jks = trained(kind)
    rows = np.asarray(jks._dimred_inputs(), np.float32)
    jfull = np.asarray(jax.vmap(jks.basis.lift_full)(rows))
    np.testing.assert_allclose(port.full_lift().numpy(), jfull,
                               rtol=2.4e-7, atol=0)
    assert port.N == jks.N == (129 if kind == "nonlinear" else 28)
    P, J = port.basis.pcs, np.asarray(jks.basis.pcs)
    assert P.shape == J.shape
    np.testing.assert_allclose(P * np.sign(np.sum(P * J, axis=0)), J,
                               rtol=0, atol=1e-10)


@pytest.mark.parametrize("kind", KINDS)
def test_model_matrices_match_jax_after_sign_alignment(kind):
    port, jks = trained(kind)
    pm, jm = port.model, jks.model
    s = econ_signs(port, jks)
    m = port.m

    def close(a, b, what):
        b = np.asarray(b, np.float64)
        err = np.abs(np.asarray(a, np.float64) - b).max() / np.abs(b).max()
        assert err < 1e-4, (what, err)
    np.testing.assert_array_equal(pm.C, np.asarray(jm.C))
    if kind == "nonlinear":
        close(pm.W, s[:, None] * np.asarray(jm.W), "W")
        close(pm.K, s[:, None] * np.asarray(jm.K) * s[None], "K")
        return
    S = s[:, None] * s[None]
    close(pm.A, S * np.asarray(jm.A), "A")
    if kind == "linear":
        close(pm.B, s[:, None] * np.asarray(jm.B), "B")
        close(pm.M, S * np.asarray(jm.M), "M")
        se = np.concatenate([s, np.ones(m)])
    else:
        close(pm.B, s[:, None, None] * np.asarray(jm.B) * s[None, None],
              "Beta")
        se = np.tile(s, m + 1)
    close(pm.K, se[:, None] * np.asarray(jm.K) * se[None], "K")


@pytest.mark.parametrize("kind", KINDS)
def test_one_step_predictions_match_jax(kind):
    port, jks = trained(kind)
    assert dataclasses.asdict(port.model.meta) == \
        dataclasses.asdict(jks.model.meta)
    p = one_step_predictions(port.model, port.valdata, "cpu")
    j = jax_predictions(jks.model, jks.valdata)
    assert p.shape == j.shape == (5 * 1200, 6)
    assert np.abs(p - j).max() < 1e-5


@pytest.mark.parametrize("kind", KINDS)
def test_validate_matches_jax(kind):
    port, jks = trained(kind)
    pe = [float(v["error"]["euclid_mean"]) for v in port.validate()]
    je = [float(v["error"]["euclid_mean"]) for v in jks.validate()]
    np.testing.assert_allclose(pe, je, rtol=1e-3, equal_nan=True)
    # the nonlinear model's open loop diverges on validation trials 0 and
    # 3 in both packages; every other rollout stays finite
    assert sum(map(math.isfinite, pe)) == (3 if kind == "nonlinear" else 5)


def test_f64_training_on_a_slice_matches_jax_tightly():
    """cfg.dtype='float64' on 2 training trials and 1 validation trial:
    the f64 lift and JAX's default-cutoff SVD solve on both sides."""
    full = corpus()
    ds = DataSet(train=full.train[:2], val=full.val[:1], params=full.params)
    kw = dict(cfg_kw("bilinear"), dtype="float64")
    port = Ksysid(ds, SysidConfig(**kw), device="cpu").train_models()
    jks = JKsysid(jax_dataset(ds), JSysidConfig(**kw)).train_models()
    assert port.model.A.dtype == np.float64 and port.N == jks.N
    p = one_step_predictions(port.model, port.valdata, "cpu")
    j = jax_predictions(jks.model, jks.valdata)
    assert np.abs(p - j).max() < 1e-9
    pe = float(port.validate()[0]["error"]["euclid_mean"])
    je = float(jks.validate()[0]["error"]["euclid_mean"])
    assert abs(pe - je) < 1e-9 * max(1.0, abs(je))


# ---------------------------------------------------------- module cases


@pytest.mark.parametrize("nd", [0, 1, 2])
def test_delay_embed_matches_jax(nd):
    from koopman_realizations_tpu.ops.observables import delay_embed as jde
    tr = corpus().train[0]
    for a, b in zip(delay_embed(tr.y, tr.u, nd), jde(tr.y, tr.u, nd)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("nd", [0, 1])
def test_finite_snapshots_take_the_same_seeded_subsample(nd):
    full = corpus()
    ds = DataSet(train=full.train[:3], val=full.val[:1], params=full.params)
    kw = dict(model_type="linear", obs_type=("poly",), obs_degree=(2,),
              delays=nd, snapshots=500, seed=3)
    port = Ksysid(ds, SysidConfig(**kw), device="cpu")
    jks = JKsysid(jax_dataset(ds), JSysidConfig(**kw))
    assert port.snapshot_pairs.alpha.shape == (500, 6 * (nd + 1) + 3 * nd)
    for f in ("alpha", "beta", "u"):
        np.testing.assert_array_equal(getattr(port.snapshot_pairs, f),
                                      np.asarray(getattr(jks.snapshot_pairs,
                                                         f)))


@pytest.mark.parametrize("threshold", [99.0, 99.99])
def test_pcs_for_explained_matches_jax(threshold):
    from koopman_realizations_tpu.ops.linalg import pcs_for_explained as jp
    rng = np.random.default_rng(7)
    X = rng.standard_normal((400, 30)) * np.logspace(0, -4, 30)
    J = jp(X, threshold)
    P = pcs_for_explained(torch.from_numpy(X), threshold).numpy()
    assert P.shape == J.shape and 1 < J.shape[1] < 30
    np.testing.assert_allclose(P * np.sign(np.sum(P * J, axis=0)), J,
                               rtol=0, atol=1e-10)


@pytest.mark.parametrize("rule", ["f32", "f64"])
def test_lstsq_on_a_rank_deficient_matrix(rule):
    """Duplicated columns: the minimum-norm solution splits the weight
    evenly, as numpy's lstsq (rcond = f32 eps, the f32 rule) and the JAX
    ``lstsq`` (refine=0, its default cutoff, the f64 rule) do."""
    from koopman_realizations_tpu.ops.lstsq import lstsq as jlstsq
    rng = np.random.default_rng(11)
    A0 = rng.standard_normal((200, 8))
    A = np.concatenate([A0, A0[:, :3]], axis=1)        # rank 8 of 11
    B = rng.standard_normal((200, 4))
    if rule == "f32":
        rcond = float(np.finfo(np.float32).eps)
        ref = np.linalg.lstsq(A, B, rcond=rcond)[0]
    else:
        rcond = None
        ref = np.asarray(jlstsq(A, B, refine=0))
    X = lstsq(torch.from_numpy(A), torch.from_numpy(B), rcond=rcond).numpy()
    np.testing.assert_allclose(X, ref, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(X[:3], X[8:], rtol=1e-10, atol=1e-12)


def _trials_with_loads():
    rng = np.random.default_rng(5)
    out = []
    for k in range(3):
        T = 20 + k
        w = np.stack([np.full(T, 0.3), rng.random(T)], axis=1)
        out.append(Trial(t=np.arange(T) * 0.05, y=rng.standard_normal((T, 2)),
                         u=rng.standard_normal((T, 1)),
                         x=rng.standard_normal((T, 4)), w=w))
    return out


def test_merge_trials_matches_jax():
    trs = _trials_with_loads()
    port = merge_trials(trs)
    jax_m = jtypes.merge_trials(
        [jtypes.Trial(t=t.t, y=t.y, u=t.u, x=t.x, w=t.w) for t in trs])
    for f in ("t", "y", "u", "x", "w"):
        np.testing.assert_array_equal(getattr(port, f),
                                      np.asarray(getattr(jax_m, f)))
    assert merge_trials(trs[:1]) is trs[0]


def test_data_utilities_match_jax():
    """resample, chop, get_data4sysid and merge_files of utils/data.py."""
    from koopman_realizations_tpu.utils import data as jdata
    from koopman_realizations_torch.utils import data as tdata
    tr = _trials_with_loads()[2]
    jtr = jtypes.Trial(t=tr.t, y=tr.y, u=tr.u, x=tr.x, w=tr.w)
    pairs = [(tdata.resample(tr, 0.03), jdata.resample(jtr, 0.03))]
    pairs += list(zip(tdata.chop(tr, 3, 0.25), jdata.chop(jtr, 3, 0.25)))
    assert len(pairs) == 4
    for a, b in pairs:
        for f in ("t", "y", "u", "x", "w"):
            np.testing.assert_array_equal(getattr(a, f),
                                          np.asarray(getattr(b, f)))
    ds = tdata.get_data4sysid([tr], [tr], params={"Ts": 0.05})
    merged = tdata.merge_files([ds, ds])
    assert [len(merged.train), len(merged.val)] == [2, 2]
    assert all(a is tr for a in merged.train + merged.val)
    assert merged.params == {"Ts": 0.05} and merged.isfake


def test_fit_scaler_and_trial_down_match_jax():
    """The shift-only rule for the constant load dimension included."""
    from koopman_realizations_tpu.ops.scaling import fit_scaler as jfit
    merged = merge_trials(_trials_with_loads())
    port = fit_scaler(merged)
    jsc = jfit(jtypes.Trial(t=merged.t, y=merged.y, u=merged.u, x=merged.x,
                            w=merged.w))
    for f in dataclasses.fields(port):
        np.testing.assert_allclose(getattr(port, f.name),
                                   np.asarray(getattr(jsc, f.name)),
                                   rtol=1e-12, atol=0)
    assert port.w_factor[0] == 1.0 and port.w_offset[0] == 0.3
    pd, jd = port.trial_down(merged), jsc.trial_down(merged)
    for f in ("y", "u", "x", "w"):
        np.testing.assert_allclose(getattr(pd, f), np.asarray(getattr(jd, f)),
                                   rtol=1e-12, atol=1e-15)
    assert pd.t is merged.t


# ------------------------------------------------- persistence and raises


@pytest.mark.parametrize("kind", KINDS)
def test_save_model_reads_back_in_both_packages(kind, tmp_path):
    from koopman_realizations_tpu.utils.checkpoint import (
        load_model as jload,
    )
    port, _ = trained(kind)
    path = save_model(tmp_path / kind, port.model, port.scaler)
    assert path.endswith(".npz")
    assert save_model(tmp_path / kind, port.model).endswith(f"{kind} (2).npz")
    jm, jsc = jload(path)
    tm, tsc, header = load_model(path)
    names = {"linear": ("A", "B", "C", "M", "K"),
             "bilinear": ("A", "B", "C", "K"),
             "nonlinear": ("W", "C", "K")}[kind]
    for name in names:
        ref = getattr(port.model, name)
        np.testing.assert_array_equal(np.asarray(getattr(jm, name)), ref)
        np.testing.assert_array_equal(getattr(tm, name), ref)
        assert getattr(tm, name).dtype == ref.dtype
    np.testing.assert_array_equal(tm.basis.pcs, port.basis.pcs)
    np.testing.assert_array_equal(np.asarray(jm.basis.pcs), port.basis.pcs)
    for f in ("y_factor", "y_offset", "u_factor", "u_offset"):
        np.testing.assert_array_equal(getattr(tsc, f),
                                      getattr(port.scaler, f))
        np.testing.assert_array_equal(np.asarray(getattr(jsc, f)),
                                      getattr(port.scaler, f))
    assert tm.meta == port.model.meta and math.isinf(tm.lasso)
    assert header["class"] == type(port.model).__name__


@pytest.mark.parametrize("change,item", [
    (dict(loaded=True, delays=1), 7),
    ("snapshots", 10),
])
def test_what_is_not_ported_raises(change, item):
    """Both cases the trainer once refused are ported now: loads with
    delays (item 7; held to JAX in ``test_torch_loaded_delays.py``) and a
    datafile's pre-extracted snapshot pairs (item 10; held to JAX in
    ``test_torch_matio.py``), which replace the trials' own pairs."""
    full = corpus()
    ds = DataSet(train=full.train[:1], val=full.val[:1], params=full.params)
    kw = dict(model_type="linear", obs_degree=(2,))
    if item == 7:
        from koopman_realizations_torch.utils.data import (
            LOADED_CORPUS,
            load_corpus,
        )
        ks = Ksysid(load_corpus(LOADED_CORPUS), SysidConfig(**kw, **change),
                    device="cpu")
        assert (ks.nd, ks.nw) == (1, 2)
        return
    rng = np.random.default_rng(0)
    sp = {"alpha": rng.uniform(-1, 1, (40, 6)),
          "beta": rng.uniform(-1, 1, (40, 6)),
          "u": rng.uniform(-1, 1, (40, 3))}
    ks = Ksysid(dataclasses.replace(ds, snapshots=sp), SysidConfig(**kw),
                device="cpu")
    for f in ("alpha", "beta", "u"):
        np.testing.assert_array_equal(getattr(ks.snapshot_pairs, f), sp[f])
    assert ks.snapshot_pairs.w is None
    assert ks.train_models().model.A.shape == (ks.N, ks.N)


def test_trainer_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    full = corpus()
    ds = DataSet(train=full.train[:1], val=full.val[:1])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Ksysid(ds, SysidConfig(obs_degree=(2,)))


# ----------------------------------------------------------- closed loop


def test_port_trained_bilinear_model_runs_the_asset_loop():
    """B=4 x 30 blockM steps of the bench controller (plain path, f64) on
    the port-trained bilinear model and on the committed asset: the
    same models to ~1e-7 in one step, so the same loop (bound 1e-4 m on
    every tracked output; measured below 1e-6)."""
    port, _ = trained("bilinear")
    asset, ascaler, _ = load_model()
    arm = Arm(ArmConfig(**BENCH_ARM), device="cpu")
    outs = []
    for model, scaler in ((port.model, port.scaler), (asset, ascaler)):
        mpc = BilinearKmpc(model, scaler, MpcConfig(**BENCH_MPC),
                           device="cpu", dtype=torch.float64)
        run = Ksim(arm, mpc, device="cpu").batched_runner(
            blockM_reference(), steps=30)
        outs.append(run(bench_X0(4), np.zeros((4, 2), np.float32)))
    for o in outs:
        assert bool(o["alive"].all()) and torch.isfinite(o["Yp"]).all()
    assert (outs[0]["Yp"] - outs[1]["Yp"]).abs().max() < 1e-4
