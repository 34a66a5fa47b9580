"""Poly observable tables and the plain poly lift (port of the JAX
package's ``ops/observables.py:42-101`` and ``KoopmanBasis.lift``).

Basis layout (reference-exact): the econ basis is
[zeta ; pcs^T g(zeta) ; 1] with g = [zeta ; monomials of degree 2..d ; 1]
and monomial rows in ``partitions.m`` order.  The lift here is lanes-minor:
zeta is (nz, B), features are (rows, B).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

__all__ = ["partitions_ones", "poly_exponents", "poly_parent_tables",
           "poly_features", "KoopmanBasis"]


def partitions_ones(total: int, n: int) -> np.ndarray:
    """All non-negative integer vectors of length ``n`` summing to
    ``total``, in ``partitions.m`` order (recurse over the count of the
    LAST element)."""
    if n == 1:
        return np.array([[total]], dtype=np.int32)
    rows = []
    for i in range(total + 1):
        sub = partitions_ones(total - i, n - 1)
        rows.append(np.concatenate(
            [sub, np.full((sub.shape[0], 1), i, np.int32)], axis=1))
    return np.concatenate(rows, axis=0)


def poly_exponents(nzeta: int, degree: int) -> np.ndarray:
    """Exponent rows of all monomials of total degree 1..degree."""
    return np.concatenate([partitions_ones(d, nzeta)
                           for d in range(1, degree + 1)], axis=0)


def poly_parent_tables(nz: int, degree: int):
    """Parent-recurrence gather tables of the degree-blocked poly lift.

    Every degree-d monomial is z_i times a unique degree-(d-1) parent (its
    lowest nonzero exponent dimension).  Returns (blocks, tables): the
    exponent blocks of degrees 1..degree and, for degrees 2..degree,
    (parent_idx, dim_idx) int32 arrays indexing the previous block / z.
    """
    blocks = [partitions_ones(d, nz) for d in range(1, degree + 1)]
    tables = []
    pos = {tuple(int(v) for v in e): r for r, e in enumerate(blocks[0])}
    for d in range(2, degree + 1):
        parent_idx = np.empty(len(blocks[d - 1]), np.int32)
        dim_idx = np.empty(len(blocks[d - 1]), np.int32)
        newpos = {}
        for r, row in enumerate(blocks[d - 1]):
            e = tuple(int(v) for v in row)
            i = next(k for k in range(nz) if e[k] > 0)
            parent = e[:i] + (e[i] - 1,) + e[i + 1:]
            parent_idx[r] = pos[parent]
            dim_idx[r] = i
            newpos[e] = r
        tables.append((parent_idx, dim_idx))
        pos = newpos
    return blocks, tables


def poly_features(zeta: torch.Tensor, tables) -> torch.Tensor:
    """Monomials of degree 2.. of lanes-minor ``zeta`` (nz, B), one gather
    and one multiply per degree block: (n_mono, B)."""
    idx = lambda a: torch.as_tensor(a, dtype=torch.long, device=zeta.device)
    feats, prev = [], zeta
    for parent_idx, dim_idx in tables:
        prev = prev[idx(parent_idx)] * zeta[idx(dim_idx)]
        feats.append(prev)
    if not feats:
        return zeta.new_zeros((0,) + tuple(zeta.shape[1:]))
    return torch.cat(feats, dim=0)


@dataclasses.dataclass(frozen=True, eq=False)
class KoopmanBasis:
    """The observable dictionary fields the port reads (single poly family,
    optional PCA econ basis)."""

    model_type: str
    n: int
    m: int
    nd: int
    nw: int
    families: Tuple[Tuple[str, int], ...]
    pcs: Optional[np.ndarray] = None          # (N_full, npcs)

    @property
    def nzeta(self) -> int:
        return self.n * (self.nd + 1) + self.m * self.nd

    @property
    def nzeta_aug(self) -> int:
        return self.nzeta + (self.m if self.model_type == "nonlinear" else 0)

    def poly_tables(self):
        (kind, degree), = self.families
        if kind != "poly":
            raise NotImplementedError(f"observable family {kind!r}")
        return poly_parent_tables(self.nzeta_aug, degree)[1]

    def lift(self, zeta: torch.Tensor) -> torch.Tensor:
        """Working (econ) basis of lanes-minor zeta (nz, B): (N, B)."""
        ones = zeta.new_ones((1,) + tuple(zeta.shape[1:]))
        g = torch.cat([zeta, poly_features(zeta, self.poly_tables()), ones])
        if self.pcs is None:
            return g
        P_T = torch.as_tensor(self.pcs.T, dtype=zeta.dtype,
                              device=zeta.device)
        return torch.cat([zeta, P_T @ g, ones])
