"""The reference's ``.mat`` formats and the host utilities of the port
(``utils/matio.py``, ``utils/naming.py``, ``utils/checkpoint.py:
export_mat``, ``utils/trajectories.py``), the trainer on a datafile's
pre-extracted snapshot pairs, and the example scripts, against the JAX
package on files the tests write themselves (the reference's datafiles
are not in the repository).

- Every saver of the port is read back by JAX's loader and every JAX
  saver by the port's: arrays bitwise, names and layouts equal.
- ``Ksysid`` with pre-extracted pairs (every other pair of a 2-trial
  slice, f64) against JAX ``Ksysid`` on the same ``DataSet``: the pairs
  as given, one-step predictions within 1e-9 (as
  ``tests/test_torch_edmd.py``'s f64 slice).
- ``export_mat`` against JAX's on the three committed assets, array by
  array, bitwise.
- ``model_classname``, ``get_pacman`` and ``get_polygon``: equal.
- Each example script's ``main()`` on a tiny corpus it writes.
"""

import os
import sys

import numpy as np
import pytest
import scipy.io as sio

from koopman_realizations_tpu import types as jtypes
from koopman_realizations_tpu.config import SysidConfig as JSysidConfig
from koopman_realizations_tpu.models.edmd import Ksysid as JKsysid
from koopman_realizations_tpu.utils import checkpoint as JCk
from koopman_realizations_tpu.utils import matio as JM
from koopman_realizations_tpu.utils import naming as JN
from koopman_realizations_tpu.utils import trajectories as JT

from koopman_realizations_torch.config import SysidConfig
from koopman_realizations_torch.models.edmd import Ksysid
from koopman_realizations_torch.types import DataSet, Trial
from koopman_realizations_torch.utils import checkpoint as TCk
from koopman_realizations_torch.utils import matio as TM
from koopman_realizations_torch.utils import naming as TN
from koopman_realizations_torch.utils import trajectories as TT
from koopman_realizations_torch.utils.data import load_corpus
from koopman_realizations_torch.utils.metrics import one_step_predictions

from test_torch_oracle import (
    ROOT,
    jax_dataset,
    one_thread,  # noqa: F401  (fixture)
)
from test_torch_oracle import one_step_predictions as jax_one_step

pytestmark = pytest.mark.usefixtures("one_thread")

sys.path.insert(0, str(ROOT / "examples"))


def _trials(rng, k, T=7, loaded=False):
    return [Trial(t=np.arange(T) * 0.05, y=rng.normal(size=(T, 4)),
                  u=rng.normal(size=(T, 2)), x=rng.normal(size=(T, 4)),
                  w=rng.normal(size=(T, 2)) if loaded else None)
            for _ in range(k)]


def _same_trials(a, b):
    assert len(a) == len(b)
    for p, q in zip(a, b):
        for f in ("t", "y", "u", "x", "w"):
            pa, qa = getattr(p, f), getattr(q, f)
            assert (pa is None) == (qa is None), f
            if pa is not None:
                assert np.array_equal(np.asarray(pa), np.asarray(qa)), f


def _jds(ds):
    conv = lambda trs: [jtypes.Trial(t=tr.t, y=tr.y, u=tr.u, x=tr.x,
                                     w=tr.w) for tr in trs]
    return jtypes.DataSet(train=conv(ds.train), val=conv(ds.val),
                          params=ds.params)


@pytest.mark.parametrize("loaded", [False, True])
def test_data4sysid_both_ways(tmp_path, loaded):
    rng = np.random.default_rng(0)
    ds = DataSet(train=_trials(rng, 3, loaded=loaded),
                 val=_trials(rng, 1, loaded=loaded))
    TM.save_data4sysid(str(tmp_path / "port.mat"), ds, folder_name="f")
    JM.save_data4sysid(str(tmp_path / "jax.mat"), _jds(ds), folder_name="f")
    for f in ("port.mat", "jax.mat"):
        mine = TM.load_data4sysid(str(tmp_path / f))
        theirs = JM.load_data4sysid(str(tmp_path / f))
        _same_trials(mine.train, ds.train)
        _same_trials(mine.val, ds.val)
        _same_trials(theirs.train, mine.train)
        _same_trials(theirs.val, mine.val)
    a, b = sio.loadmat(tmp_path / "port.mat"), sio.loadmat(tmp_path / "jax.mat")
    assert sorted(k for k in a if not k.startswith("__")) == \
        sorted(k for k in b if not k.startswith("__"))


def test_rsys_ensemble_both_ways(tmp_path):
    rng = np.random.default_rng(1)
    sets = [DataSet(train=_trials(rng, 2), val=_trials(rng, 1))
            for _ in range(3)]
    pa = TM.save_rsys_ensemble(str(tmp_path / "port"), sets)
    ja = JM.save_rsys_ensemble(str(tmp_path / "jax"), [_jds(d) for d in sets])
    assert os.path.basename(pa) == os.path.basename(ja)
    assert sorted(os.listdir(tmp_path / "port")) == \
        sorted(os.listdir(tmp_path / "jax"))
    for path in (pa, ja):
        for loader in (TM.load_rsys_all, JM.load_rsys_all):
            got = loader(path)
            assert len(got) == 3
            for g, d in zip(got, sets):
                _same_trials(g.train, d.train)
                _same_trials(g.val, d.val)


def test_ref_trajectory_and_results_both_ways(tmp_path):
    ref = TT.make_trajectory(TT.get_pacman([0.1, -0.5], 0.3), T=5.0,
                             Ts=0.05, name="pacman")
    TM.save_ref_trajectory(str(tmp_path / "port.mat"), ref)
    JM.save_ref_trajectory(str(tmp_path / "jax.mat"), ref)
    for f in ("port.mat", "jax.mat"):
        for loader in (TM.load_ref_trajectory, JM.load_ref_trajectory):
            got = loader(str(tmp_path / f))
            assert got["name"] == "pacman" and got["T"] == 5.0
            assert np.array_equal(got["y"], ref["y"])
            assert np.array_equal(got["t"], ref["t"])
    rng = np.random.default_rng(2)
    res = {"U": rng.normal(size=(10, 3)), "Y": rng.normal(size=(10, 6)),
           "err": rng.random(10), "comp_time": rng.random(10)}
    TM.save_results_mat(str(tmp_path / "rp.mat"), res)
    JM.save_results_mat(str(tmp_path / "rj.mat"), res)
    for f in ("rp.mat", "rj.mat"):
        for loader in (TM.load_sim_results, JM.load_sim_results):
            got = loader(str(tmp_path / f))
            assert set(got) == set(res)
            for k in res:
                assert np.array_equal(np.asarray(got[k]).reshape(
                    res[k].shape), res[k]), k


def test_snapshot_pairs_of_a_datafile_train_as_jax():
    """A datafile's pre-extracted pairs (every other pair of a 2-trial
    slice) replace the trials' own; f64 training, both packages."""
    full = load_corpus()
    base = DataSet(train=full.train[:2], val=full.val[:1],
                   params=full.params)
    kw = dict(model_type="bilinear", obs_type=("poly",), obs_degree=(3,),
              dim_red=True, dtype="float64")
    own = Ksysid(base, SysidConfig(**kw), device="cpu").snapshot_pairs
    sp = {"alpha": own.alpha[::2], "beta": own.beta[::2], "u": own.u[::2]}
    ds = DataSet(train=base.train, val=base.val, params=base.params,
                 snapshots=sp)
    port = Ksysid(ds, SysidConfig(**kw), device="cpu")
    for f in ("alpha", "beta", "u"):
        assert np.array_equal(getattr(port.snapshot_pairs, f), sp[f])
    port.train_models()
    jd = jax_dataset(base)
    jks = JKsysid(jtypes.DataSet(train=jd.train, val=jd.val,
                                 params=jd.params, snapshots=sp),
                  JSysidConfig(**kw)).train_models()
    p = one_step_predictions(port.model, port.valdata, "cpu")
    j = jax_one_step(jks.model, jks.valdata)
    assert np.abs(p - j).max() < 1e-9
    plain = Ksysid(base, SysidConfig(**kw), device="cpu").train_models()
    assert np.abs(one_step_predictions(plain.model, plain.valdata, "cpu")
                  - p).max() > 1e-9


@pytest.mark.parametrize("asset", ["arm3_bilinear_poly3.npz",
                                   "arm3_linear_poly3.npz",
                                   "arm3_nonlinear_poly3.npz"])
def test_export_mat_matches_jax(tmp_path, asset):
    path = ROOT / "koopman_realizations_torch" / "assets" / asset
    model = TCk.load_model(path)[0]
    jmodel = JCk.load_model(str(path))[0]
    mine = sio.loadmat(TCk.export_mat(str(tmp_path / "port"), model))
    theirs = sio.loadmat(JCk.export_mat(str(tmp_path / "jax"), jmodel))
    a, b = mine["model"][0, 0], theirs["model"][0, 0]
    assert a.dtype.names == b.dtype.names
    for name in a.dtype.names:
        assert np.array_equal(a[name], b[name]), name
    if "bilinear" in asset:
        NL, m = model.A.shape[0], model.meta.m
        assert a["B"].shape == (NL, m * NL)
        np.testing.assert_array_equal(a["B"][:, NL:2 * NL], model.B[:, 1, :])


def test_naming_and_trajectories_match_jax():
    for args in (("bilinear", "poly", 3, 6, 3, 0),
                 ("linear", "fourier", (2, 3), 4, 2, 1)):
        assert TN.model_classname(*args, timestamp="2020-06-09_16-43") == \
            JN.model_classname(*args, timestamp="2020-06-09_16-43")
    assert TN.model_classname("linear", "poly", 1, 1, 1, 0).startswith(
        "linear_poly-1_n-1_m-1_del-0_")
    for c, r in (([0.1, -0.5], 0.3), ((0.0, 0.0), 1.0)):
        assert np.array_equal(TT.get_pacman(c, r), JT.get_pacman(c, r))
    v = [[0, 0], [1, 0], [0.5, 0.7]]
    assert np.array_equal(TT.get_polygon(v), JT.get_polygon(v))
    assert TT.get_polygon(v).dtype == np.float64


def test_example_scripts_on_a_tiny_corpus(tmp_path, capsys):
    """generate -> .mat -> train (and save) -> control, -> the random
    systems' sweep, each script's main() on the CPU; a missing default
    datafile ends the run naming it."""
    import evaluate_rand_models_torch as ER
    import example_control_torch as EC
    import example_sysid_torch as ES
    import generate_arm_data_torch as EG
    mat = str(tmp_path / "d.mat")
    ds = EG.main(["--trials", "4", "--tf", "3", "--val", "1", "--device",
                  "cpu", "--out", mat])
    back = TM.load_data4sysid(mat)
    _same_trials(back.train, ds.train)
    models = ES.main(["--datafile", mat, "--device", "cpu", "--save",
                      str(tmp_path / "models")])
    assert set(models) == {"linear", "bilinear", "nonlinear"}
    assert len(os.listdir(tmp_path / "models")) == 3
    out = EC.main(["--datafile", mat, "--device", "cpu", "--steps", "3",
                   "--batch", "2"])
    assert out["bilinear"]["err"].shape == (2,)
    assert out["batch"]["alive"].shape == (2, 2)
    rand = ER.main(["--generate", "2", "--device", "cpu"])
    assert rand["linear"]["err"].shape == (13, 2)
    with pytest.raises(SystemExit, match="missing"):
        ES.main(["--datafile", str(tmp_path / "absent.mat"), "--device",
                 "cpu"])
    with pytest.raises(SystemExit, match="missing"):
        ER.main(["--folder", str(tmp_path), "--device", "cpu"])
    assert "generated 3 train + 1 val trials" in capsys.readouterr().out
