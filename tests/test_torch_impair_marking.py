"""The ECN-marking laws (DCQCN, Reno, reTCP) under per-link impairments.

``test_torch_impair_engines.py::check_three_engines``: the port's padded,
slot and plain megakernel engines on the impaired k = 4 fat-tree anchor,
bit for bit ``repro``'s runs and one another.
"""
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_impair_engines import check_three_engines  # noqa: E402


@pytest.mark.parametrize("law", ["dcqcn", "reno", "retcp"])
def test_three_engines_bitmatch_impaired(law):
    check_three_engines(law)
