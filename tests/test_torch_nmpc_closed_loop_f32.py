"""The port's NMPC general runner on its f32 plain path, B=16 over the
full 301 steps, against the asset header's JAX general runner: every lane
alive, err_mean within 1e-3 (measured 2.8e-5).  The f64 run and the rest
of the closed-loop checks are in ``test_torch_nmpc_closed_loop.py``; this
one has a file of its own so that the two ~100 s loops run on different
test workers."""

import pytest
import torch

from test_torch_nmpc_closed_loop import check_against_header
from test_torch_oracle import one_thread  # noqa: F401  (fixture)

# one torch thread a test process: the xdist workers' pools would
# oversubscribe the machine
pytestmark = pytest.mark.usefixtures("one_thread")


def test_nmpc_closed_loop_f32_matches_jax_reference():
    check_against_header(torch.float32, 1e-3)
