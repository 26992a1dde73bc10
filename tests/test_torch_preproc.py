"""The port's host preprocessing (``hawq_tpu_torch.utils.preproc``) against
``hawq_tpu.utils.preproc``, tolerance 0, on odd batches and sizes, uint8
and float32.  ``preprocess_batch`` and ``fold4_images_3x3s2`` run the
port's native library (the JAX package's C++ loops for them, built by each
package with g++) and give the same bytes as the JAX package's; their numpy
paths, reached by taking the library away, equal the JAX package's numpy
paths and (but for ``preprocess_batch``'s PIL resize) the native one.
``fold4_images``, ``quantize_int8`` and ``pack_int4`` are numpy only in the
port and equal the JAX package's native and numpy paths alike.
"""

import numpy as np
import pytest
import torch

from hawq_tpu.utils import preproc as jp

from hawq_tpu_torch.utils import preproc as tp

torch.set_num_threads(1)

MEAN = np.array([0.485, 0.456, 0.406], np.float32)
STD = np.array([0.229, 0.224, 0.225], np.float32)


@pytest.fixture(params=['native', 'numpy'])
def path(request, monkeypatch):
    """Both packages on their native libraries, or both on numpy."""
    if request.param == 'numpy':
        monkeypatch.setattr(tp, '_load', lambda: None)
        monkeypatch.setattr(jp, '_load', lambda: None)
    else:
        assert tp.native_available() and jp.native_available()
    return request.param


def _images(shape, dtype, seed=0):
    rng = np.random.RandomState(seed)
    if dtype == np.uint8:
        return rng.randint(0, 256, shape).astype(np.uint8)
    return rng.randn(*shape).astype(dtype)


@pytest.mark.parametrize('dtype', [np.uint8, np.float32])
def test_fold4_images(path, dtype):
    x = _images((3, 12, 20, 3), dtype)
    got = tp.fold4_images(x)
    assert got.dtype == dtype and got.shape == (3, 5, 7, 48)
    np.testing.assert_array_equal(got, jp.fold4_images(x))
    from hawq_tpu_torch.inference.fold import fold4_images
    np.testing.assert_array_equal(got, fold4_images(x))


@pytest.mark.parametrize('p0', [0, 1])
@pytest.mark.parametrize('dtype', [np.uint8, np.float32])
def test_fold4_images_3x3s2(path, p0, dtype):
    x = _images((3, 13, 17, 3), dtype, seed=p0)
    got = tp.fold4_images_3x3s2(x, p0)
    np.testing.assert_array_equal(got, jp.fold4_images_3x3s2(x, p0))
    from hawq_tpu_torch.inference.fold import fold4_images_3x3s2
    np.testing.assert_array_equal(got, fold4_images_3x3s2(x, p0))


def test_fold4_needs_multiples_of_4(path):
    with pytest.raises(ValueError):
        tp.fold4_images(np.zeros((1, 13, 16, 3), np.float32))


@pytest.mark.parametrize('scale', [0.25, 0.0517, 3.0])
def test_quantize_int8_half_boundaries(path, scale):
    """Random values, and values whose quotient lies on a .5 boundary
    (round half up there), and ones past the clip range."""
    rng = np.random.RandomState(1)
    k = rng.randint(-140, 140, 999).astype(np.float32)
    x = np.concatenate([(k + np.float32(0.5)) * np.float32(scale),
                        rng.randn(1001).astype(np.float32) * 40 * scale])
    x = x.reshape(2, 1000)
    got = tp.quantize_int8(x, scale)
    assert got.dtype == np.int8 and got.shape == x.shape
    np.testing.assert_array_equal(got, jp.quantize_int8(x, scale))
    want = np.clip(np.floor(x / np.float32(scale) + np.float32(0.5)),
                   -128, 127).astype(np.int8)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tp.quantize_int8(x, scale, 0, 15),
                                  jp.quantize_int8(x, scale, 0, 15))


@pytest.mark.parametrize('k,n', [(2, 1), (64, 24), (118, 37)])
def test_pack_int4(path, k, n):
    w = np.random.RandomState(k).randint(-8, 8, (k, n)).astype(np.int8)
    got = tp.pack_int4(w)
    assert got.shape == (k // 2, n)
    np.testing.assert_array_equal(got, jp.pack_int4(w))
    from hawq_tpu_torch.kernels.matmul import pack_int4
    np.testing.assert_array_equal(got, pack_int4(w))
    with pytest.raises(ValueError):
        tp.pack_int4(w[:-1] if k > 2 else w[:1])


@pytest.mark.parametrize('hw,resize,crop', [((37, 53), 40, 32),
                                            ((61, 45), 36, 31)])
def test_preprocess_batch(path, hw, resize, crop):
    imgs = _images((3, *hw, 3), np.uint8, seed=hw[0])
    got = tp.preprocess_batch(imgs, resize, crop, MEAN, STD)
    assert got.dtype == np.float32 and got.shape == (3, crop, crop, 3)
    np.testing.assert_array_equal(got, jp.preprocess_batch(imgs, resize,
                                                           crop, MEAN, STD))
    assert np.isfinite(got).all()
