"""Model loading from the JAX package's ``.npz`` handoff format
(``utils/checkpoint.py:save_model``: one JSON ``header`` entry plus the
model, PCA and scaler arrays)."""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from koopman_realizations_torch.models.koopman import from_jax_arrays

ASSETS = Path(__file__).resolve().parents[1] / "assets"
BENCH_MODEL = ASSETS / "arm3_bilinear_poly3.npz"


def load_model(path=BENCH_MODEL):
    """(model, scaler, header) of a model written by the JAX ``save_model``.

    The header also carries whatever the writer added beside the JAX
    fields (for the bench asset: its provenance and the JAX general
    runner's tracking error, ``header["jax_reference"]``).
    """
    with np.load(path, allow_pickle=False) as data:
        header = json.loads(str(data["header"]))
        arrays = {k: data[k] for k in data.files if k != "header"}
    if header.get("class") != "BilinearModel":
        raise NotImplementedError(
            f"only BilinearModel files are ported (got {header.get('class')})")
    model, scaler = from_jax_arrays(header, arrays)
    return model, scaler, header
