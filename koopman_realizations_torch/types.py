"""Data containers of training (port of ``types.py:55-145`` of the JAX
package): a trial, the train/validation split and the EDMD snapshot pairs.

Plain frozen dataclasses holding host numpy arrays; training moves what it
lifts to the device itself.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class Trial:
    """One experiment/simulation trial (reference: trial struct).

    t: [T]    time stamps
    y: [T,n]  measured outputs
    u: [T,m]  inputs
    x: [T,nx] optional full internal state
    w: [T,nw] optional load condition
    """

    t: Any
    y: Any
    u: Any
    x: Optional[Any] = None
    w: Optional[Any] = None

    @property
    def n(self) -> int:
        return self.y.shape[-1]

    @property
    def m(self) -> int:
        return self.u.shape[-1]

    @property
    def T(self) -> int:
        return self.y.shape[-2]

    @property
    def Ts(self) -> float:
        return float(np.mean(np.diff(np.asarray(self.t))))

    def replace(self, **kw) -> "Trial":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class DataSet:
    """The ``data4sysid`` container: train + validation trials.

    ``params`` marks a simulated ("fake") system (``Ksysid.m:60-66``);
    ``snapshots`` holds pre-extracted snapshot pairs of a datafile
    ({alpha, beta, u[, w]}, ``Ksysid.m:931-938``).
    """

    train: list
    val: list
    params: Optional[dict] = None
    snapshots: Optional[dict] = None

    @property
    def isfake(self) -> bool:
        return self.params is not None


@dataclasses.dataclass(frozen=True)
class SnapshotPairs:
    """EDMD snapshot pairs (``Ksysid.get_snapshotPairs:910-984``).

    alpha: [K, nzeta]  state (with delays) before the step
    beta:  [K, nzeta]  state after the step
    u:     [K, m]      input applied between them
    w:     [K, nw]     optional load during the step
    """

    alpha: Any
    beta: Any
    u: Any
    w: Optional[Any] = None


def merge_trials(trials: list) -> Trial:
    """Concatenate several trials into one long Trial
    (``Ksysid.merge_trials:380-401``): a plain row concat of every field.
    The time vector restarts at trial boundaries, which is how
    ``get_snapshot_pairs`` drops the pairs that straddle one."""
    if len(trials) == 1:
        return trials[0]

    def cat(xs):
        if any(x is None for x in xs):
            return None
        return np.concatenate([np.asarray(x) for x in xs], axis=0)
    return Trial(t=cat([tr.t for tr in trials]),
                 y=cat([tr.y for tr in trials]),
                 u=cat([tr.u for tr in trials]),
                 x=cat([tr.x for tr in trials]),
                 w=cat([tr.w for tr in trials]))
