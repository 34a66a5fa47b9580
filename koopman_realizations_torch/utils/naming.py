"""Model naming (port of ``utils/naming.py:model_classname`` of the JAX
package; reference ``Ksysid.save_class:406-450``).  ``auto_rename`` is
``utils/checkpoint.py``'s."""

from __future__ import annotations

import time
from typing import Optional


def model_classname(model_type: str, obs_type: str, obs_degree, n: int,
                    m: int, nd: int, timestamp: Optional[str] = None) -> str:
    """``modeltype_obstype-deg_n-_m-_del-_timestamp``
    (``Ksysid.m:431-433``); the timestamp defaults to now,
    ``%Y-%m-%d_%H-%M``."""
    if timestamp is None:
        timestamp = time.strftime("%Y-%m-%d_%H-%M")
    if not isinstance(obs_degree, (list, tuple)):
        obs_degree = (obs_degree,)
    deg = "-".join(str(d) for d in obs_degree)
    return f"{model_type}_{obs_type}-{deg}_n-{n}_m-{m}_del-{nd}_{timestamp}"


__all__ = ["model_classname"]
