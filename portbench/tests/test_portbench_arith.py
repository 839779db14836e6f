"""The yardstick's arithmetic on known inputs: byte counts, the
percentile, the trace's busy time and idle gaps, TF32 rounding."""

import pytest
import torch

from core import roofline, trace
from core.stats import percentile
from reference.solvers import round_tf32


def test_field_bytes_match_the_recorded_bounds():
    # PERF.md's bounds at 32x128x256 f32: K1 16.3 us, K2 15.0, K5 18.8
    shape = (32, 128, 256)
    us = {k: 1e6 * roofline.least_seconds(roofline.field_bytes(k, shape, 4))
          for k in ("K1", "K2", "K5")}
    assert us["K1"] == pytest.approx(16.27, abs=0.01)
    assert us["K2"] == pytest.approx(15.02, abs=0.01)
    assert us["K5"] == pytest.approx(18.78, abs=0.01)


def test_tridiag_bytes_match_values_moved():
    # the annulus momentum solve at 256x3072: lower and upper (256, 1, 1),
    # diag and rhs (256, 2, 3074), x written: ops/tridiag.py values_moved
    nr, cols = 256, 2 * 3074
    values = 2 * nr + 3 * nr * cols
    assert roofline.tridiag_bytes((256, 3072), 2, 4) == 4 * values
    assert 1e6 * roofline.least_seconds(
        roofline.tridiag_bytes((256, 3072), 2, 4)) == pytest.approx(5.64,
                                                                    abs=0.01)
    assert 1e6 * roofline.least_seconds(
        roofline.tridiag_bytes((256, 3072), 1, 4)) == pytest.approx(2.82,
                                                                    abs=0.01)


@pytest.mark.parametrize("values,q,want", [
    ([1.0], 95, 1.0),
    (list(range(1, 101)), 95, 95),
    (list(range(1, 21)), 95, 19),
    (list(range(20, 0, -1)), 95, 19),
    ([5, 1, 3], 50, 3),
])
def test_percentile_nearest_rank(values, q, want):
    assert percentile(values, q) == want


def test_busy_and_gaps():
    K = trace.Kernel
    ks = [K("a", 10, 20), K("b", 15, 30), K("c", 50, 60)]
    w = trace.Window(ks, 0.0, 100.0, 3, [("host_x", 30.0, 50.0),
                                         ("outer", 0.0, 100.0)])
    assert trace.busy_us(ks, 0, 100) == 30
    assert trace.busy_us(ks, 12, 55) == 23
    assert trace.idle_gaps(w) == [(0.0, 10), (30, 50), (60, 100.0)]
    gaps = dict(trace.gaps_by_host(w))
    assert gaps["host_x"] == pytest.approx(20e-6)
    assert gaps["outer"] == pytest.approx(50e-6)
    assert trace.device_ops(w)[0] == ["b", 15e-6]


def test_kernel_names():
    assert trace.kernel_id("void rich_fused<float, 8, true>(...)") == "K1"
    assert trace.kernel_id("void thomas_pair<float>(...)") == "K4"
    assert trace.category("sm90_xmma_gemm_f32f32") == "gemm"
    assert trace.category("void forcing_kernel<float, true>") == "hand"
    assert trace.category("elementwise_kernel") == "plain"


def test_round_tf32():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 2 ** -10 + 2 ** -12,
                      3.0e-5], dtype=torch.float32)
    y = round_tf32(x)
    assert y[0] == 1.0
    assert y[1] == 1.0                      # tie to even
    assert y[2] == 1.0 + 2 ** -10
    assert abs(float(y[3]) / 3.0e-5 - 1) < 2 ** -11
    assert round_tf32(x.double()) is not None
