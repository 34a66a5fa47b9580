"""Arm training corpora without JAX (the port of ``examples/
generate_arm_data.py:generate``; reference ``Arm_setup.m``,
``Arm.simulate_rampNhold`` and ``Data.get_data4sysid``).

Every excitation trial runs at once as lanes of one batch
(``Arm.simulate_rampNhold_batch``: on the card a replayed CUDA graph of
the control period); the ramp-and-hold tables are drawn on the host from
one seeded numpy Generator in the JAX package's order, so the inputs are
bitwise the JAX generator's and the outputs agree to the plants' rounding
(``tests/test_torch_arm_data.py``, chip_smoke.py phase GN1).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from koopman_realizations_torch.config import ArmConfig
from koopman_realizations_torch.models.arm import Arm
from koopman_realizations_torch.types import DataSet, Trial
from koopman_realizations_torch.utils.data import get_data4sysid

ASSETS = Path(__file__).resolve().parents[1] / "assets"
# the corpus arm of the JAX generator (generate_arm_data.py:27-28)
CORPUS_ARM = dict(Nmods=3, nlinks=1, L=1.0, m=0.1, output_type="markers",
                  substeps=5)
# the recipes of the three committed corpora (each file's header names
# its own): ``generate`` on the corpus arm with marker and with angle
# outputs, and the loaded experiment's ramp-and-hold batch on the
# 2-module arm over a 16-load grid (JAX tests/test_loaded.py:22-38)
CORPORA = {
    "markers": dict(file="arm3_corpus.npz", arm=CORPUS_ARM, trials=15,
                    tf=60.0, n_val=5, seed=0),
    "angles": dict(file="arm3_angles_corpus.npz",
                   arm=dict(CORPUS_ARM, output_type="angles"), trials=15,
                   tf=60.0, n_val=5, seed=0),
    "loaded": dict(file="arm2_loaded_corpus.npz",
                   arm=dict(CORPUS_ARM, Nmods=2), seed=7, tf=30.0,
                   Tramp=2.0, loads=[[a, b] for a in (0.0, 0.33, 0.66, 1.0)
                                     for b in (-1.0, -0.33, 0.33, 1.0)]),
}


def trials_of(sims) -> list:
    """``Trial``s (t, y, u, x, w) of ``simulate_rampNhold*`` dicts."""
    return [Trial(t=s["t"], y=s["y"], u=s["u"], x=s["x"], w=s["w"])
            for s in sims]


def generate(trials: int = 15, tf: float = 60.0, Tramp: float = 2.5,
             n_val: int = 5, seed: int = 0, cfg: ArmConfig = None,
             device="cuda", dtype=torch.float64) -> DataSet:
    """A DataSet of ``trials`` unloaded excitation trials of ``tf``
    seconds from ``seed``: the last ``n_val`` (clamped to keep at least
    one of each) for validation, params {sysName, Nmods, Ts}; the arm
    ``cfg`` (default the corpus arm) in ``dtype`` on ``device``."""
    cfg = cfg or ArmConfig(**CORPUS_ARM)
    arm = Arm(cfg, device=device)
    n_val = max(1, min(n_val, trials - 1))
    sims = arm.simulate_rampNhold_batch(np.random.default_rng(seed), tf=tf,
                                        Tramp=Tramp, W=np.zeros((trials, 2)),
                                        dtype=dtype)
    out = trials_of(sims)
    return get_data4sysid(out[:-n_val], out[-n_val:],
                          params={"sysName": "arm-generated",
                                  "Nmods": cfg.Nmods, "Ts": cfg.Ts})


def corpus(name: str, device="cuda", dtype=torch.float64) -> DataSet:
    """The DataSet of a ``CORPORA`` recipe, generated by the port: the
    loaded one's trials all but the last for training."""
    r = CORPORA[name]
    cfg = ArmConfig(**r["arm"])
    if "loads" not in r:
        return generate(r["trials"], r["tf"], n_val=r["n_val"],
                        seed=r["seed"], cfg=cfg, device=device, dtype=dtype)
    sims = Arm(cfg, device=device).simulate_rampNhold_batch(
        np.random.default_rng(r["seed"]), tf=r["tf"], Tramp=r["Tramp"],
        W=np.asarray(r["loads"]), dtype=dtype)
    out = trials_of(sims)
    return DataSet(train=out[:-1], val=out[-1:],
                   params={"sysName": "loaded"})


def corpus_distance(ds: DataSet, path) -> dict:
    """A generated DataSet against a committed corpus file, trial by
    trial: whether t, u (and w where the file has it) are bitwise equal,
    and the largest |y - y_file|."""
    out = {"t_equal": True, "u_equal": True, "w_equal": True, "y_max": 0.0}
    with np.load(path, allow_pickle=False) as data:
        for split in ("train", "val"):
            for i, tr in enumerate(getattr(ds, split)):
                key = f"{split}{i}_"
                out["t_equal"] &= np.array_equal(tr.t, data[key + "t"])
                out["u_equal"] &= np.array_equal(tr.u, data[key + "u"])
                if key + "w" in data.files:
                    out["w_equal"] &= np.array_equal(tr.w, data[key + "w"])
                out["y_max"] = max(out["y_max"], float(
                    np.abs(tr.y - data[key + "y"]).max()))
        out["trials"] = sum(k.endswith("_t") for k in data.files)
    out["trials_equal"] = out["trials"] == len(ds.train) + len(ds.val)
    return out


__all__ = ["CORPUS_ARM", "CORPORA", "generate", "trials_of", "corpus",
           "corpus_distance"]
