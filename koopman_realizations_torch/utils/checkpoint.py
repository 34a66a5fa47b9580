"""Model persistence in the JAX package's ``.npz`` handoff format
(``utils/checkpoint.py:35-72``: one JSON ``header`` entry plus the model,
PCA and scaler arrays): the port's ``save_model`` writes what the JAX
``load_model`` reads, and ``load_model`` reads both packages' files.
``export_mat`` writes a model's matrices in the reference's ``.mat``
model struct (:105-124)."""

from __future__ import annotations

import dataclasses
import json
import os
from pathlib import Path
from typing import Optional

import numpy as np

from koopman_realizations_torch.models.koopman import (
    MODEL_CLASSES,
    BilinearModel,
    from_jax_arrays,
)
from koopman_realizations_torch.ops.scaling import Scaler

ASSETS = Path(__file__).resolve().parents[1] / "assets"
BENCH_MODEL = ASSETS / "arm3_bilinear_poly3.npz"
LINEAR_MODEL = ASSETS / "arm3_linear_poly3.npz"
NONLINEAR_MODEL = ASSETS / "arm3_nonlinear_poly3.npz"
# the loaded-arm experiment's models (nw = 2), trained by the JAX package
LOADED_BILINEAR_MODEL = ASSETS / "arm2_loaded_bilinear_poly2.npz"
LOADED_LINEAR_MODEL = ASSETS / "arm2_loaded_linear_poly2.npz"
# the loaded bilinear recipe at delays=1 (nzeta = 10)
LOADED_DELAYED_MODEL = ASSETS / "arm2_loaded_bilinear_poly2_del1.npz"


def auto_rename(path: str) -> str:
    """Append " (2)", " (3)", ... to the stem until the path does not
    exist (``utils/naming.py:auto_rename``, reference ``auto_rename.m``)."""
    if not os.path.exists(path):
        return path
    root, ext = os.path.splitext(path)
    k = 2
    while os.path.exists(f"{root} ({k}){ext}"):
        k += 1
    return f"{root} ({k}){ext}"


def save_model(path, model, scaler: Optional[Scaler] = None,
               overwrite: bool = False) -> str:
    """Save a model (and its scaler) to ``path``.npz in the JAX package's
    format: a JSON header (class, meta, lasso, basis, has_scaler) and the
    arrays A, B, C, M, K, W that the model has, gaussian_centers, pcs and
    ``scaler_<field>`` (JAX ``utils/checkpoint.py:35-72``).
    Without ``overwrite`` an existing file is kept and the name gets a
    " (k)" suffix.  Returns the path written."""
    path = str(path)
    if not path.endswith(".npz"):
        path += ".npz"
    if not overwrite:
        path = auto_rename(path)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    b = model.basis
    header = {
        "class": type(model).__name__,
        "meta": dataclasses.asdict(model.meta),
        "lasso": float(model.lasso),
        "basis": {"model_type": b.model_type, "n": b.n, "m": b.m,
                  "nd": b.nd, "nw": b.nw,
                  "families": [list(f) for f in b.families],
                  "has_centers": b.gaussian_centers is not None,
                  "has_pcs": b.pcs is not None},
        "has_scaler": scaler is not None,
    }
    arrays = {name: np.asarray(getattr(model, name))
              for name in ("A", "B", "C", "M", "K", "W")
              if getattr(model, name, None) is not None}
    if b.gaussian_centers is not None:
        arrays["gaussian_centers"] = np.asarray(b.gaussian_centers)
    if b.pcs is not None:
        arrays["pcs"] = np.asarray(b.pcs)
    if scaler is not None:
        arrays.update({"scaler_" + f.name: np.asarray(getattr(scaler, f.name))
                       for f in dataclasses.fields(scaler)
                       if getattr(scaler, f.name) is not None})
    np.savez(path, header=json.dumps(header), **arrays)
    return path


def load_model(path=BENCH_MODEL):
    """(model, scaler, header) of a model written by ``save_model`` of
    either package.

    The header also carries whatever the writer added beside the JAX
    fields (for the three committed assets, ``BENCH_MODEL`` (bilinear),
    ``LINEAR_MODEL`` and ``NONLINEAR_MODEL``: their provenance and the JAX
    general runner's tracking error, ``header["jax_reference"]``).
    """
    with np.load(path, allow_pickle=False) as data:
        header = json.loads(str(data["header"]))
        arrays = {k: data[k] for k in data.files if k != "header"}
    classes = {c.__name__ for c in MODEL_CLASSES.values()}
    if header.get("class") not in classes:
        raise NotImplementedError(
            f"only {sorted(classes)} files are ported "
            f"(got {header.get('class')})")
    model, scaler = from_jax_arrays(header, arrays)
    return model, scaler, header


def export_mat(path, model) -> str:
    """Write the model's A, B, C, M, K, W that it has as the reference's
    ``model`` struct (.mat, scipy): a bilinear B (NL, m, NL) goes back to
    the reference's (NL, m*NL) column blocks, a C-order reshape.  Returns
    the path written (``.mat`` appended when missing)."""
    import scipy.io as sio

    path = str(path)
    if not path.endswith(".mat"):
        path += ".mat"
    out = {name: np.asarray(getattr(model, name))
           for name in ("A", "C", "M", "K", "W")
           if getattr(model, name, None) is not None}
    if getattr(model, "B", None) is not None:
        B = np.asarray(model.B)
        out["B"] = B.reshape(B.shape[0], -1) \
            if isinstance(model, BilinearModel) else B
    sio.savemat(path, {"model": out})
    return path
