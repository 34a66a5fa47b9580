"""Koopman model containers of the port (``models/koopman.py`` of the JAX
package): bilinear realization z+ = A z + Beta(z) u, y = C z, with
Beta(z) = einsum('kmj,j->km', B, z).

The port does not train yet: a model arrives as the JAX trainer's arrays
(``from_jax_arrays``), usually through the ``.npz`` handoff format
(``utils.checkpoint.load_model``).  Arrays stay host numpy here; the
controller turns what it needs into device buffers.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

from koopman_realizations_torch.ops.observables import KoopmanBasis
from koopman_realizations_torch.ops.scaling import Scaler


@dataclasses.dataclass(frozen=True)
class ModelMeta:
    """Static metadata shared by all model types (reference ``params``)."""

    model_type: str
    time_type: str
    n: int
    m: int
    nd: int
    nw: int
    N: int
    nzeta: int
    Ts: float

    @property
    def NL(self) -> int:
        return self.N * (self.nw + 1)


@dataclasses.dataclass(frozen=True, eq=False)
class BilinearModel:
    """z+ = A z + Beta(z) u; B is stored as (NL, m, NL)."""

    A: Any
    B: Any
    C: Any
    meta: ModelMeta
    basis: KoopmanBasis

    @property
    def dtype(self) -> np.dtype:
        return np.asarray(self.A).dtype


def from_jax_arrays(header: dict, arrays: dict):
    """(BilinearModel, Scaler | None) from the JAX package's parameters.

    ``header`` has the ``meta`` and ``basis`` entries of the JAX
    ``save_model`` header; ``arrays`` maps names to numpy arrays: A, B, C,
    pcs (when the basis has one) and ``scaler_<field>`` entries.
    """
    meta = ModelMeta(**header["meta"])
    if meta.model_type != "bilinear" or meta.time_type != "discrete":
        raise NotImplementedError(
            f"only discrete bilinear models are ported "
            f"(got {meta.model_type}/{meta.time_type})")
    b = header["basis"]
    basis = KoopmanBasis(
        model_type=b["model_type"], n=b["n"], m=b["m"], nd=b["nd"],
        nw=b["nw"], families=tuple(tuple(f) for f in b["families"]),
        pcs=np.asarray(arrays["pcs"]) if "pcs" in arrays else None)
    model = BilinearModel(A=np.asarray(arrays["A"]),
                          B=np.asarray(arrays["B"]),
                          C=np.asarray(arrays["C"]), meta=meta, basis=basis)
    fields = [f.name for f in dataclasses.fields(Scaler)]
    skw = {f: np.asarray(arrays["scaler_" + f]) for f in fields
           if "scaler_" + f in arrays}
    scaler = Scaler(**skw) if skw else None
    return model, scaler
