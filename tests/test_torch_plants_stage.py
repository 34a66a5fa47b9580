"""The bench's bilinear controller in the port's general runner on the
arm integrated by SDIRK2 with exact Newton ('stage', ``ArmConfig()``'s 10
substeps and 3 Newton iterations), 16 lanes x 301 steps in f64 against
``assets/plant_refs.json`` (see ``test_torch_plants.py``, whose holding
this file shares; a file of its own so that two test workers share the
three plants' loops)."""

import pytest

from test_torch_oracle import one_thread  # noqa: F401  (fixture)
from test_torch_plants import hold_to_the_refs

pytestmark = pytest.mark.usefixtures("one_thread")


def test_stage_plant_in_the_loop_matches_the_refs():
    hold_to_the_refs("stage")
