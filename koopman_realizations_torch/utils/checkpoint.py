"""Model loading from the JAX package's ``.npz`` handoff format
(``utils/checkpoint.py:save_model``: one JSON ``header`` entry plus the
model, PCA and scaler arrays)."""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from koopman_realizations_torch.models.koopman import (
    MODEL_CLASSES,
    from_jax_arrays,
)

ASSETS = Path(__file__).resolve().parents[1] / "assets"
BENCH_MODEL = ASSETS / "arm3_bilinear_poly3.npz"
LINEAR_MODEL = ASSETS / "arm3_linear_poly3.npz"
NONLINEAR_MODEL = ASSETS / "arm3_nonlinear_poly3.npz"


def load_model(path=BENCH_MODEL):
    """(model, scaler, header) of a model written by the JAX ``save_model``.

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
