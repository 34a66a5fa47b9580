"""PyTorch/CUDA port of the Koopman-MPC engine (``koopman_realizations_tpu``).

The JAX package is the reference and stays as it is; this package mirrors its
module paths and never imports JAX or anything of the JAX package.  Per-step
math runs on lanes-minor ``(rows, B)`` tensors, one column per closed-loop
scenario; on the card the hot path runs in hand-written CUDA kernels
(``ops/kernels``), each with a plain PyTorch version beside it.

Entry points take ``device=`` (default ``"cuda"``) and raise when CUDA is
absent; the CPU path is taken only when the caller asks for it.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device="cuda") -> torch.device:
    """The torch device an entry point runs on; raises if it is a CUDA
    device and CUDA is not available (no silent move to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch path on the host")
    return dev
