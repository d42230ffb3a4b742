"""``optik_tpu_torch/utils/roofline.py``: the H100's published peaks, the
bound as the larger of operations and bytes, and the FP32 operations a
Panda lane-iteration needs (the count the kernel's bound has used since it
was introduced: 2,015, from ``lm_kernel.fp32_ops_per_lane_iter``)."""

import pytest

from optik_tpu_torch import SolverConfig
from optik_tpu_torch.models import ChainSpec, asset_path
from optik_tpu_torch.utils import roofline

H100 = "NVIDIA H100 80GB HBM3"


def test_peaks_are_the_h100_published_figures():
    assert roofline.fp32_peak_flops(H100) == 66.9e12
    assert roofline.memory_peak_bytes(H100) == 3.35e12
    assert roofline.fp32_peak_flops("TPU v5 lite") is None
    assert roofline.memory_peak_bytes("cpu") is None


def test_bound_is_the_larger_of_operations_and_bytes():
    ms, by = roofline.bound_ms(66.9e9, 1.0, H100)
    assert by == "operations" and ms == pytest.approx(1.0)
    ms, by = roofline.bound_ms(1.0, 3.35e9, H100)
    assert by == "bytes" and ms == pytest.approx(1.0)
    with pytest.raises(ValueError, match="no published peaks"):
        roofline.bound_ms(1.0, 1.0, "TPU v5 lite")


def test_utilization_against_the_fp32_peak():
    out = roofline.utilization(1e9, 1.0, 2000.0, H100)
    assert out["model_gflops_per_s"] == pytest.approx(2000.0)
    assert out["fp32_util"] == pytest.approx(2e12 / 66.9e12)
    assert "fp32_util" not in roofline.utilization(1e9, 1.0, 2000.0, "cpu")


def test_lane_iter_cost_of_the_panda():
    spec = ChainSpec.from_urdf_file(asset_path("panda.urdf"), "panda_link0",
                                    "panda_hand_tcp")
    cost = roofline.lane_iter_cost(spec, SolverConfig())
    assert cost == {"flops": 2015.0}
