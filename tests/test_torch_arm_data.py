"""Corpus generation without JAX (``workflows/arm_data.py``) against the
committed corpora that the JAX package wrote, on the CPU in f64.

- ``generate(15, 60.0, n_val=5, seed=0)`` against ``assets/
  arm3_corpus.npz`` and the loaded recipe (16 loads, seed 7) against
  ``assets/arm2_loaded_corpus.npz``, trial by trial: t, u and w bitwise,
  y within 1e-8 (measured 4.4e-16 and 3.3e-16: the one-step parity of the
  two packages' SDIRK2 is 1e-10 to 1e-12, ``tests/test_torch_arm.py``,
  and the damped arm does not amplify it over 1200 steps);
- the recipes are the ones the oracle wrote the files with
  (``tests/test_torch_oracle.py``: ``CORPUS``, ``LOADED``,
  ``ANGLE_CORPUS_RECIPE``), and each file's header names them.
"""

import json

import numpy as np
import pytest

from koopman_realizations_torch.workflows.arm_data import (
    ASSETS,
    CORPORA,
    CORPUS_ARM,
    corpus,
    corpus_distance,
    generate,
)

from test_torch_oracle import (
    ANGLE_CORPUS_RECIPE,
    CORPUS,
    LOADED,
    one_thread,  # noqa: F401  (fixture)
)

pytestmark = pytest.mark.usefixtures("one_thread")


def test_recipes_are_the_oracles():
    m, a, ld = CORPORA["markers"], CORPORA["angles"], CORPORA["loaded"]
    assert {k: m[k] for k in CORPUS} == CORPUS
    assert {k: a[k] for k in ("trials", "tf", "n_val", "seed")} == \
        {k: ANGLE_CORPUS_RECIPE[k] for k in ("trials", "tf", "n_val",
                                             "seed")}
    assert a["arm"] == ANGLE_CORPUS_RECIPE["arm"]
    assert ld["arm"] == LOADED["arm"]
    c = LOADED["corpus"]
    assert (ld["seed"], ld["tf"], ld["Tramp"]) == (c["seed"], c["tf"],
                                                  c["Tramp"])
    assert np.array_equal(ld["loads"], c["loads"])
    for name, r in CORPORA.items():
        with np.load(ASSETS / r["file"], allow_pickle=False) as data:
            header = json.loads(str(data["header"]))
        if name == "loaded":
            assert "default_rng(7), tf=30.0, Tramp=2.0" in header["recipe"]
        else:
            assert "generate(15, 60.0, n_val=5, seed=0" in header["recipe"]
            assert ("angles" in header["recipe"]) == (name == "angles")
    assert CORPUS_ARM == dict(m["arm"])


@pytest.mark.parametrize("name", ["markers", "loaded"])
def test_port_regenerates_the_corpus(name):
    ds = corpus(name, device="cpu")
    d = corpus_distance(ds, ASSETS / CORPORA[name]["file"])
    assert d["trials_equal"] and d["t_equal"] and d["u_equal"] \
        and d["w_equal"], d
    assert d["y_max"] < 1e-8, d
    if name == "markers":
        assert ds.params == {"sysName": "arm-generated", "Nmods": 3,
                             "Ts": 0.05}
        assert (len(ds.train), len(ds.val)) == (10, 5)
        assert ds.train[0].x.shape == (1201, 6)


def test_generate_clamps_the_split():
    """n_val clamps to leave a train and a validation trial (the JAX
    generator's rule)."""
    ds = generate(2, 0.5, n_val=5, seed=1, device="cpu")
    assert (len(ds.train), len(ds.val)) == (1, 1)
    ds = generate(3, 0.5, n_val=0, seed=1, device="cpu")
    assert (len(ds.train), len(ds.val)) == (2, 1)
