"""The data-parallel cell's path over four CPU ranks (gloo): it agrees with
the one-process reference over the global batch, and leaving out the
exchange between the ranks fails the comparison."""

import pytest

from portbench.tests import tiny


@pytest.mark.parametrize("plant", [None, "no_exchange"])
def test_four_ranks(plant):
    result, lines = tiny.run("resnet50-dp4-b256", plant=plant)
    assert result["correct"] is (plant is None), lines
    assert result["device"]["count"] == 4
