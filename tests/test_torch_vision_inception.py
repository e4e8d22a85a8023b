"""GoogLeNet's three heads at 224 and Inception v3's eval forwards in the
port against the reference's on the CPU, from the reference's weights:
the two heaviest families of ``tests/test_torch_vision_models.py``, run
here with its helper and tolerance so that each file stays short.
"""
import pytest

from test_torch_vision_models import INCEPTION, check_family_forward


@pytest.mark.parametrize("family", INCEPTION)
def test_inception_family_forward_from_the_references_weights(family):
    check_family_forward(family)
