"""The benchmark's kernel counts reproduce the bounds PERF.md's kernel
table holds (chip_smoke.py's `bound`, `_subpix_work`, `_b3_bound`)."""

import pytest

from benchmark.roofline import b1, b2, b3, peaks


def test_b1_bound_at_the_fine_pass():
    assert b1.bound_ms((32, 540, 960), 16, 4) == pytest.approx(0.1061,
                                                               abs=5e-5)
    assert b1.bound_ms((32, 270, 480), 16, 4) == pytest.approx(0.0265,
                                                               abs=5e-5)


def test_b2_bound_at_the_detector_batch():
    assert b2.bound_ms(32 * 384, ((6, 6), (3, 4)), 1) == pytest.approx(
        0.00335, abs=5e-6)
    assert b2.patch_radius(((6, 6), (3, 4))) == 13


def test_b3_bound_at_n201_m48():
    assert b3.bound_ms(1, 201, 48) == pytest.approx(0.00082, abs=5e-6)
    assert b3.bound_ms(8, 201, 48) == pytest.approx(0.0065, abs=5e-5)


def test_peaks_and_what_sets_the_bound():
    assert peaks.F32_PEAK == 67e12 and peaks.HBM_RATE == 3.35e12
    assert peaks.INT32_PEAK == pytest.approx(132 * 64 * 1.98e9)
    assert peaks.bound(1.0, 1e12, 1e12)[1] == "bytes"
    assert peaks.bound(1e12, 1.0, 1e12)[1] == "operations"
