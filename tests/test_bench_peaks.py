"""bench.py's published-peak table: known devices only."""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import bench  # noqa: E402


def test_h100_peaks():
    peaks = bench.device_peaks("NVIDIA H100 80GB HBM3")
    assert peaks == {"flops": 67e12, "hbm_bytes_per_s": 3.35e12}


@pytest.mark.parametrize("kind", ["cpu", "NVIDIA A100-SXM4-80GB", ""])
def test_unknown_device_is_an_error(kind):
    with pytest.raises(ValueError, match="no published peaks"):
        bench.device_peaks(kind)
