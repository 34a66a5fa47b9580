"""Koopman model containers of the port (``models/koopman.py`` of the JAX
package): the linear realization z+ = A z + B u and the bilinear one
z+ = A z + Beta(z) u with Beta(z) = einsum('kmj,j->km', B, z), both with
y = C z, and the nonlinear one zeta+ = W^T g([zeta; u]).

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
class LinearModel:
    """z+ = A z + B u; B is (NL, m)."""

    A: Any
    B: Any
    C: Any
    meta: ModelMeta
    basis: KoopmanBasis

    @property
    def dtype(self) -> np.dtype:
        return np.asarray(self.A).dtype


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


@dataclasses.dataclass(frozen=True, eq=False)
class NonlinearModel:
    """zeta+ = W^T g([zeta; u]), the discrete Koopman vector field; W is
    (N, nzeta) and C the (n, n) identity (``Ksysid.m:1337``)."""

    W: Any
    C: Any
    meta: ModelMeta
    basis: KoopmanBasis

    @property
    def dtype(self) -> np.dtype:
        return np.asarray(self.W).dtype


MODEL_CLASSES = {"linear": LinearModel, "bilinear": BilinearModel,
                 "nonlinear": NonlinearModel}


def from_jax_arrays(header: dict, arrays: dict):
    """(LinearModel | BilinearModel | NonlinearModel, Scaler | None) from
    the JAX package's parameters.

    ``header`` has the ``meta`` and ``basis`` entries of the JAX
    ``save_model`` header; ``arrays`` maps names to numpy arrays: the
    model's own (A, B, C, or W and C for the nonlinear model), pcs (when
    the basis has one) and ``scaler_<field>`` entries.
    """
    meta = ModelMeta(**header["meta"])
    if meta.model_type not in MODEL_CLASSES or meta.time_type != "discrete":
        raise NotImplementedError(
            f"only discrete linear, bilinear and nonlinear models are "
            f"ported (got {meta.model_type}/{meta.time_type})")
    b = header["basis"]
    basis = KoopmanBasis(
        model_type=b["model_type"], n=b["n"], m=b["m"], nd=b["nd"],
        nw=b["nw"], families=tuple(tuple(f) for f in b["families"]),
        pcs=np.asarray(arrays["pcs"]) if "pcs" in arrays else None)
    cls = MODEL_CLASSES[meta.model_type]
    model = cls(meta=meta, basis=basis, **{
        f.name: np.asarray(arrays[f.name]) for f in dataclasses.fields(cls)
        if f.name not in ("meta", "basis")})
    fields = [f.name for f in dataclasses.fields(Scaler)]
    skw = {f: np.asarray(arrays["scaler_" + f]) for f in fields
           if "scaler_" + f in arrays}
    scaler = Scaler(**skw) if skw else None
    return model, scaler
