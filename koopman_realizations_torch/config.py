"""Configuration dataclasses of the port (subset of the JAX package's).

Only the fields that the bilinear closed loop reads are carried over from
``koopman_realizations_tpu/config.py`` (``MpcConfig`` :61, ``ArmConfig``
:170); names and defaults are the same, so a configuration translates
field for field.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class MpcConfig:
    """Knobs of the model-predictive controller (Kmpc)."""

    horizon: Optional[int] = None        # default floor(1/Ts)
    input_bounds: Optional[Tuple[float, float]] = None   # scalar pair or (m,2)
    input_slopeConst: Optional[float] = None
    input_smoothConst: Optional[float] = None
    state_bounds: Optional[Tuple[float, float]] = None
    input_blocks: Optional[Tuple[int, ...]] = None   # move blocking groups
    cost_running: float = 0.1
    cost_terminal: float = 100.0
    cost_input: Sequence[float] = (0.0,)
    proj_idx: Optional[Tuple[int, ...]] = None
    qp_iters: int = 12
    qp_dual_warm: bool = False
    qp_dual_shift: bool = False
    bilinear_iters: int = 1


@dataclasses.dataclass(frozen=True)
class ArmConfig:
    """Planar N-link arm physical parameters (Arm_setup.m:12-52)."""

    Nmods: int = 3
    nlinks: int = 1
    L: float = 1.0
    k: float = -1e-5
    d: float = 10.0
    m: float = 0.1
    g: float = 9.81
    ku: float = 10.0
    Ts: float = 0.05
    output_type: str = "markers"
    substeps: int = 10
    integrator: str = "sdirk2"
    newton_iters: int = 3
    jac_mode: str = "substep"

    @property
    def Nlinks(self) -> int:
        return self.Nmods * self.nlinks

    @property
    def l(self) -> float:
        return self.L / self.Nlinks

    @property
    def i(self) -> float:
        return (1.0 / 3.0) * self.m * self.l ** 2

    @property
    def nx(self) -> int:
        return self.Nlinks * 2

    @property
    def ny(self) -> int:
        return {"angles": self.Nlinks, "markers": 2 * self.Nmods}[
            self.output_type]
