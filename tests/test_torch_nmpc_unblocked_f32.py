"""The port's NMPC general runner on the unblocked stack in f32 (the
plain path), B=16 over the full 301 steps, against the JAX x64 reference
(``assets/nmpc_unblocked_refs.json``): alive as JAX's and err_mean within
1e-3.  The f64 run and the solve-level checks are in
``test_torch_nmpc_unblocked.py``; this loop has a file of its own so that
the two loops run on different test workers."""

import pytest
import torch

from test_torch_nmpc_unblocked import check_loop
from test_torch_oracle import one_thread  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("one_thread")


def test_unblocked_loop_f32_matches_jax_reference():
    check_loop(torch.float32, 1e-3)
