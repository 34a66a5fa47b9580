"""Data wrangling of training (port of ``utils/data.py:17-68`` of the JAX
package, reference class ``Data``): resample, chop a long recording into
trials, pack and merge train/validation splits; and the committed arm
corpus (``load_corpus``).  Host numpy: these run once, before training.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import List, Optional

import numpy as np

from koopman_realizations_torch.types import DataSet, Trial, merge_trials

CORPUS = Path(__file__).resolve().parents[1] / "assets" / "arm3_corpus.npz"
# the loaded-arm experiment's corpus (each trial with its load w)
LOADED_CORPUS = CORPUS.with_name("arm2_loaded_corpus.npz")


def resample(trial: Trial, Ts: float) -> Trial:
    """Linear-interpolation resampling (``Data.resample:20-37``)."""
    t = np.asarray(trial.t)
    tq = np.arange(t[0], t[-1] + 1e-12, Ts)

    def interp(v):
        if v is None:
            return None
        v = np.asarray(v)
        return np.stack([np.interp(tq, t, v[:, j])
                         for j in range(v.shape[1])], axis=1)

    return Trial(t=tq, y=interp(trial.y), u=interp(trial.u),
                 x=interp(trial.x), w=interp(trial.w))


def chop(trial: Trial, num: int, length_s: float) -> List[Trial]:
    """Split one long recording into ``num`` trials of ``length_s`` seconds
    (``Data.chop:40-67``; the length is capped at duration/num, and the
    index set at the recording's end)."""
    t = np.asarray(trial.t)
    Ts = float(np.mean(np.diff(t)))
    maxlen = t[-1] / num
    length_s = min(length_s, maxlen)
    lenk = int(np.sum(t < length_s))
    maxlenk = min(int(np.sum(t < maxlen)), len(t) // num)
    lenk = min(lenk, maxlenk)

    out = []
    for i in range(num):
        idx = i * maxlenk + np.arange(lenk)

        def pick(v):
            return None if v is None else np.asarray(v)[idx]
        out.append(Trial(t=np.arange(lenk) * Ts, y=pick(trial.y),
                         u=pick(trial.u), x=pick(trial.x), w=pick(trial.w)))
    return out


def get_data4sysid(train: List[Trial], val: List[Trial],
                   params: Optional[dict] = None) -> DataSet:
    """Pack train/val trial lists (``Data.get_data4sysid:93-143``)."""
    return DataSet(train=list(train), val=list(val), params=params)


def merge_files(datasets: List[DataSet]) -> DataSet:
    """Concatenate several DataSets' splits (``Data.merge_files:70-90``)."""
    return DataSet(train=[tr for ds in datasets for tr in ds.train],
                   val=[tr for ds in datasets for tr in ds.val],
                   params=datasets[0].params)


def load_corpus(path=CORPUS) -> DataSet:
    """The DataSet of a corpus file: a JSON ``header`` (the recipe, the
    split's sizes and the data set's ``params``) and the f64 ``t``, ``y``
    and ``u`` of every trial as ``train<i>_t`` ... ``val<i>_u``, and its
    loads ``w`` where the file has them.  The committed ``CORPUS`` is
    written by ``python tests/test_torch_oracle.py --write-corpus``,
    ``LOADED_CORPUS`` by ``--write-loaded``."""
    with np.load(path, allow_pickle=False) as data:
        header = json.loads(str(data["header"]))

        def trials(split):
            return [Trial(t=data[f"{split}{i}_t"], y=data[f"{split}{i}_y"],
                          u=data[f"{split}{i}_u"],
                          w=data[f"{split}{i}_w"]
                          if f"{split}{i}_w" in data.files else None)
                    for i in range(header["split"][split])]
        return DataSet(train=trials("train"), val=trials("val"),
                       params=header["params"])


__all__ = ["CORPUS", "LOADED_CORPUS", "resample", "chop", "get_data4sysid",
           "merge_files", "merge_trials", "load_corpus"]
