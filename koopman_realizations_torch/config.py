"""Configuration dataclasses of the port (the JAX package's
``config.py``).

``SysidConfig`` and ``ArmConfig`` (:17-58, :170-227) are the JAX
package's field for field, with the same checks and derived sizes; of
``MpcConfig`` (:61, with the SQP fields of :80 and :126-164) the fields
that the port's controllers read.  Names and defaults are the same, so a
configuration translates field for field, and ``to_json`` / ``from_json``
write and read the same JSON (:230-236).
"""

from __future__ import annotations

import dataclasses
import json
import math
from typing import Optional, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class SysidConfig:
    """Knobs of EDMD / Koopman-realization training (Ksysid)."""

    model_type: str = "linear"          # 'linear' | 'bilinear' | 'nonlinear'
    time_type: str = "discrete"         # 'discrete' | 'continuous'
    obs_type: Tuple[str, ...] = ("poly",)
    obs_degree: Tuple[int, ...] = (1,)
    snapshots: float = math.inf          # number of snapshot pairs (inf = all)
    lasso: Tuple[float, ...] = (math.inf,)  # inf => plain least squares
    delays: int = 0
    loaded: bool = False
    dim_red: bool = False               # PCA dimension reduction
    pca_explained: float = 99.0         # dim_red variance threshold in %
    seed: int = 0                       # PRNG seed (subsampling)
    dtype: str = "float64"              # dtype of the lift and the models
    lasso_iters: int = 50000            # FISTA iteration cap (LASSO path)
    lasso_tol: float = 1e-12            # FISTA convergence stop

    def __post_init__(self):
        object.__setattr__(self, "obs_type", tuple(self.obs_type))
        object.__setattr__(self, "obs_degree", tuple(self.obs_degree))
        if isinstance(self.lasso, (int, float)):
            object.__setattr__(self, "lasso", (float(self.lasso),))
        else:
            object.__setattr__(self, "lasso",
                               tuple(float(v) for v in self.lasso))
        if self.model_type not in ("linear", "bilinear", "nonlinear"):
            raise ValueError(f"invalid model_type {self.model_type!r}")
        if self.time_type not in ("discrete", "continuous"):
            raise ValueError(f"invalid time_type {self.time_type!r}")
        if len(self.obs_type) != len(self.obs_degree):
            raise ValueError("obs_type and obs_degree must have the same "
                             "length")

    @property
    def liftinput(self) -> int:
        return {"linear": 0, "nonlinear": 1, "bilinear": 2}[self.model_type]


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
    mpc_type: Optional[str] = None       # default: nonlinear iff model nonlinear
    load_obs_horizon: int = 10           # load observer: regression rows,
    load_obs_period: int = 1             # steps between updates,
    load_obs_slope: Optional[float] = None   # |w - w_prev| bound per update
    proj_idx: Optional[Tuple[int, ...]] = None
    qp_iters: int = 12
    qp_dual_warm: bool = False
    qp_dual_shift: bool = False
    sqp_iters: int = 5                   # SQP relinearization passes (NMPC)
    sqp_dual_warm: bool = False          # carry each pass's multipliers on
    sqp_damping: float = 0.05            # Levenberg damping of the SQP step
    sqp_linesearch: int = 0              # merit line-search halvings per pass
    sqp_damping_decay: float = 1.0       # per-pass decay of sqp_damping
    sqp_multistart: bool = False         # cold-hold and warm-shifted inits
    sqp_update: str = "rollout"          # between-pass Z update
    sqp_init: str = "hold"               # first-pass linearization trajectory
    sqp_best_of_passes: bool = False     # keep the best-merit pass
    sqp_jac_period: int = 1              # Jacobians every this many passes
    bilinear_iters: int = 1


@dataclasses.dataclass(frozen=True)
class ArmConfig:
    """Planar N-link arm physical parameters (Arm_setup.m:12-52)."""

    Nmods: int = 3          # number of modules (actuated sections)
    nlinks: int = 1         # links per module
    L: float = 1.0          # total arm length (m)
    k: float = -1e-5        # joint stiffness
    d: float = 10.0         # joint viscous damping
    m: float = 0.1          # link mass (kg)
    g: float = 9.81
    ku: float = 10.0        # effective input stiffness
    Ts: float = 0.05        # sampling time (20 Hz)
    umax: float = math.pi / 2   # ramp-and-hold excitation amplitude
    output_type: str = "markers"   # 'angles'|'markers'|'endeff'|'shape'
    substeps: int = 10
    integrator: str = "sdirk2"      # 'sdirk2' | 'rk4' | 'rk45'
    newton_iters: int = 3           # SDIRK2 stage Newton iterations
    jac_mode: str = "substep"       # SDIRK2 Jacobian refresh: 'substep',
                                    # 'step' (one a period) or 'stage'
                                    # (exact Newton)

    @property
    def Nlinks(self) -> int:
        return self.Nmods * self.nlinks

    @property
    def l(self) -> float:
        return self.L / self.Nlinks

    @property
    def i(self) -> float:
        # link inertia: (1/3) m l^2  (Arm_setup.m:35)
        return (1.0 / 3.0) * self.m * self.l ** 2

    @property
    def nx(self) -> int:
        return self.Nlinks * 2

    @property
    def nu(self) -> int:
        return self.Nmods

    @property
    def nw(self) -> int:
        return 2

    @property
    def markerPos(self) -> Tuple[float, ...]:
        # Arm_setup.m:39
        return tuple((i * self.l * self.nlinks) / self.L
                     for i in range(self.Nmods + 1))

    @property
    def ny(self) -> int:
        return {"angles": self.Nlinks, "markers": 2 * self.Nmods,
                "endeff": 2, "shape": 6}[self.output_type]


def to_json(cfg) -> str:
    """A configuration's fields as JSON (JAX ``config.py:230``)."""
    return json.dumps(dataclasses.asdict(cfg), default=str, indent=2)


def from_json(cls, s: str):
    """The configuration of class ``cls`` that ``to_json`` wrote."""
    return cls(**json.loads(s))
