"""Loaders and savers of the reference's .mat data formats (port of
``utils/matio.py`` of the JAX package, on the port's own ``types``;
scipy on the host).

Schemas mirrored (see SURVEY.md section 2.1 #14):
- ``data4sysid`` files: struct arrays ``train``/``val`` of trial structs
  with fields t, y, u, (x), (w), (params).
- closed-loop result structs written by ``Ksim.run_trial_mpc`` with fields
  T, U, Y, K, R, X, Z, comp_time, err.
- reference trajectory files with a ``ref`` struct {name, T, Ts, t, y}.
"""

from __future__ import annotations

from typing import Optional

import os

import numpy as np
import scipy.io as sio

from koopman_realizations_torch.types import DataSet, Trial


def _mat_struct_to_dict(s) -> dict:
    if isinstance(s, sio.matlab.mat_struct):
        return {f: _mat_struct_to_dict(getattr(s, f)) for f in s._fieldnames}
    return s


def _trial_from_struct(s) -> Trial:
    def col(v):
        v = np.asarray(v, dtype=np.float64)
        return v[:, None] if v.ndim == 1 else v

    x = col(s.x) if hasattr(s, "x") else None
    w = col(s.w) if hasattr(s, "w") else None
    return Trial(t=np.asarray(s.t, np.float64).reshape(-1),
                 y=col(s.y), u=col(s.u), x=x, w=w)


def load_data4sysid(path: str) -> DataSet:
    """Load a ``data4sysid`` .mat file into a DataSet."""
    d = sio.loadmat(path, squeeze_me=True, struct_as_record=False)
    train_raw = np.atleast_1d(d["train"])
    val_raw = np.atleast_1d(d["val"])
    train = [_trial_from_struct(s) for s in train_raw]
    val = [_trial_from_struct(s) for s in val_raw]
    params = None
    if hasattr(train_raw[0], "params"):
        params = _mat_struct_to_dict(train_raw[0].params)
    return DataSet(train=train, val=val, params=params)


def load_rsys_all(path: str) -> list:
    """Load a ``rsys-all_*.mat`` ensemble file: list of DataSets."""
    d = sio.loadmat(path, squeeze_me=True, struct_as_record=False)
    out = []
    for entry in np.atleast_1d(d["data4sysid_all"]):
        train = [_trial_from_struct(s) for s in np.atleast_1d(entry.train)]
        val = [_trial_from_struct(s) for s in np.atleast_1d(entry.val)]
        out.append(DataSet(train=train, val=val))
    return out


def load_ref_trajectory(path: str) -> dict:
    """Load a reference trajectory file (``def_trajectory.m:37-40``)."""
    d = sio.loadmat(path, squeeze_me=True, struct_as_record=False)
    ref = d["ref"]
    return {
        "name": str(ref.name),
        "T": float(ref.T),
        "Ts": float(ref.Ts),
        "t": np.asarray(ref.t, np.float64).reshape(-1),
        "y": np.asarray(ref.y, np.float64),
    }


def load_sim_results(path: str, varname: Optional[str] = None) -> dict:
    """Load a golden closed-loop result struct (``Ksim.m:129-258`` fields)."""
    d = sio.loadmat(path, squeeze_me=True, struct_as_record=False)
    keys = [k for k in d if not k.startswith("__")]
    if varname is None:
        varname = keys[0]
    r = d[varname]
    out = {}
    for f in r._fieldnames:
        out[f] = np.asarray(getattr(r, f))
    return out


def save_results_mat(path: str, results: dict, varname: str = "res") -> None:
    """Save a results dict in the reference's result-struct layout."""
    sio.savemat(path, {varname: results})


# ------------------------------------------------------------------ writers
# Write-side parity: the reference saves these schemas from MATLAB
# (``Rsys.save_data``, ``def_trajectory.m:37-40``); emitting the same layouts
# makes cross-validation with MATLAB two-directional.


def _trial_to_struct(tr: Trial) -> dict:
    d = {"t": np.asarray(tr.t, np.float64).reshape(-1, 1),
         "y": np.asarray(tr.y, np.float64),
         "u": np.asarray(tr.u, np.float64)}
    if tr.x is not None:
        d["x"] = np.asarray(tr.x, np.float64)
    if tr.w is not None:
        d["w"] = np.asarray(tr.w, np.float64)
    return d


def _trial_cell(trials) -> np.ndarray:
    cell = np.empty((1, len(trials)), dtype=object)
    for j, tr in enumerate(trials):
        cell[0, j] = _trial_to_struct(tr)
    return cell


def save_data4sysid(path: str, ds: DataSet, folder_name: str = "") -> None:
    """Write a ``data4sysid`` file (the layout ``Rsys.save_data`` produces
    with ``save(..., '-struct', 'data4sysid')``, ``Rsys.m:194-207``):
    top-level ``train``/``val`` cell arrays of trial structs."""
    out = {"train": _trial_cell(ds.train), "val": _trial_cell(ds.val),
           "folder_name": folder_name}
    if ds.params:
        out["params"] = ds.params
    sio.savemat(path, out)


def save_rsys_ensemble(dirpath: str, datasets, folder_name: str = None) -> str:
    """Write per-system ``rsys-i_train-R_val-1.mat`` files plus the
    ``rsys-all`` aggregate holding ``data4sysid_all`` (``Rsys.m:182-216``).

    Returns the aggregate file path.  File/folder naming follows the
    reference scheme minus the timestamp (caller controls ``dirpath``).
    """
    os.makedirs(dirpath, exist_ok=True)
    folder_name = folder_name or os.path.basename(os.path.normpath(dirpath))
    ntr = len(datasets[0].train)
    all_cell = np.empty((len(datasets), 1), dtype=object)
    for i, ds in enumerate(datasets):
        entry = {"folder_name": folder_name,
                 "train": _trial_cell(ds.train), "val": _trial_cell(ds.val)}
        all_cell[i, 0] = entry
        sio.savemat(os.path.join(
            dirpath, f"rsys-{i + 1}_train-{ntr}_val-1.mat"), entry)
    all_path = os.path.join(dirpath, f"rsys-all_train-{ntr}_val-1.mat")
    sio.savemat(all_path, {"data4sysid_all": all_cell})
    return all_path


def save_ref_trajectory(path: str, ref: dict) -> None:
    """Write a reference-trajectory file (``def_trajectory.m:37-40``):
    one ``ref`` struct with fields name, T, Ts, t, y."""
    sio.savemat(path, {"ref": {
        "name": str(ref["name"]),
        "T": float(ref["T"]),
        "Ts": float(ref["Ts"]),
        "t": np.asarray(ref["t"], np.float64).reshape(-1, 1),
        "y": np.asarray(ref["y"], np.float64),
    }})


__all__ = ["load_data4sysid", "load_rsys_all", "load_ref_trajectory",
           "load_sim_results", "save_results_mat", "save_data4sysid",
           "save_rsys_ensemble", "save_ref_trajectory"]
