"""The port's native batch Dubins engine against the reference's.

The port builds ``aircraft_tpu_torch/native/dubins.cpp`` (the reference's
source) with g++ into its build directory; on 256 seeded problems its
``shortest_batch`` (with and without ``min_lengths``) and
``sample_batch`` are bit-equal to the reference's library, and its
pure-Python fallback (over the port's ``dubins2d``) within 1e-9 of the
native answers.  ``native_available`` is true where g++ is.
"""

import numpy as np
import pytest

from aircraft_tpu import native as jnative

from aircraft_tpu_torch import native as tnative
from aircraft_tpu_torch.kernels import _build

B = 256


def _batch(seed):
    rng = np.random.default_rng(seed)
    q = lambda: np.column_stack([rng.uniform(-50, 50, B),
                                 rng.uniform(-50, 50, B),
                                 rng.uniform(0, 2 * np.pi, B)])
    qis, qfs = q(), q()
    rhos = rng.uniform(1.0, 60.0, B)
    mins = rng.uniform(0.0, 400.0, B)
    return qis, qfs, rhos, mins


def test_builds_into_the_build_directory():
    assert tnative.native_available()
    assert tnative.lib_path("dubins").parent == _build.BUILD_DIR
    assert tnative.lib_path("dubins").exists()


@pytest.mark.parametrize("with_min", [False, True])
def test_bit_equal_to_the_reference_library(with_min):
    assert tnative.native_available() and jnative.native_available()
    qis, qfs, rhos, mins = _batch(7)
    ml = mins if with_min else None
    paths, ok = tnative.shortest_batch(qis, qfs, rhos, ml)
    rpaths, rok = jnative.shortest_batch(qis, qfs, rhos, ml)
    np.testing.assert_array_equal(paths, rpaths)
    np.testing.assert_array_equal(ok, rok)
    assert ok.sum() > B // 2
    samples = tnative.sample_batch(qis, rhos, paths, 16)
    np.testing.assert_array_equal(samples, jnative.sample_batch(qis, rhos,
                                                                rpaths, 16))
    ends = samples[ok, -1, :2]
    assert np.abs(ends - qfs[ok, :2]).max() < 1e-6 * 100


@pytest.mark.parametrize("with_min", [False, True])
def test_python_fallback_matches_native(with_min, monkeypatch):
    qis, qfs, rhos, mins = _batch(8)
    ml = mins if with_min else None
    native = tnative.shortest_batch(qis, qfs, rhos, ml)
    native_samples = tnative.sample_batch(qis, rhos, native[0], 8)
    monkeypatch.setattr(tnative, "_LIBS", {})
    monkeypatch.setattr(tnative, "_FAILED", {"dubins"})
    assert not tnative.native_available()
    paths, ok = tnative.shortest_batch(qis, qfs, rhos, ml)
    np.testing.assert_array_equal(ok, native[1])
    assert np.abs(paths - native[0]).max() <= 1e-9
    samples = tnative.sample_batch(qis, rhos, paths, 8)
    assert np.abs(samples - native_samples)[ok].max() <= 1e-9
