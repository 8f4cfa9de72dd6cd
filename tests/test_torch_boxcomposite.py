"""The port's box compositing ops (``ops/boxcomposite.py``) against the JAX
package's on seeded numpy inputs, on the CPU: ``crop_resize`` and
``paste_resize`` in both methods, ``box_mask``, ``expand_to_context_window``
and ``context_window_math``, over boxes that are fractional, clipped at the
image edge, larger than the image and degenerate (h or w below 1). The
nearest paths and the masks are bit-exact; the bilinear paths are held
within 1e-6 (fp32 weights, the same order of operations)."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from neurips18_hierchical_image_manipulation_tpu.ops import boxcomposite as jbc
from neurips18_hierchical_image_manipulation_tpu_torch.data import bbox as pbbox
from neurips18_hierchical_image_manipulation_tpu_torch.ops import boxcomposite as pbc

HW = (24, 40)
BILINEAR_ATOL = 1e-6
# (y0, x0, h, w) by kind
BOXES = {
    "fractional": [[3.3, 5.7, 9.4, 13.1], [0.5, 0.25, 7.75, 20.5]],
    "clipped": [[-4.5, 30.2, 12.0, 15.0], [18.0, -6.0, 10.5, 12.25]],
    "larger": [[-10.0, -12.0, 50.0, 70.0], [-2.5, -3.5, 30.0, 48.0]],
    "degenerate": [[5.0, 7.0, 0.5, 9.0], [10.2, 12.3, 6.0, 0.25]],
    "integer": [[2.0, 4.0, 8.0, 16.0], [0.0, 0.0, 24.0, 40.0]],
}
OUT_HW = [(16, 16), (7, 11), (32, 48)]


def images(seed, c=3, dtype=np.float32):
    rng = np.random.RandomState(seed)
    if dtype == np.int32:
        return rng.randint(0, 35000, size=(2, *HW, c)).astype(np.int32)
    return rng.uniform(-1, 1, size=(2, *HW, c)).astype(np.float32)


def jnp_t(a):
    return jnp.asarray(a)


@pytest.mark.parametrize("kind", sorted(BOXES))
@pytest.mark.parametrize("out_hw", OUT_HW)
def test_crop_resize_nearest_bit_exact(kind, out_hw):
    boxes = np.asarray(BOXES[kind], np.float32)
    for img in (images(0), images(1, c=1, dtype=np.int32).astype(np.float32)):
        want = np.asarray(jbc.crop_resize(jnp_t(img), jnp_t(boxes), out_hw, method="nearest"))
        got = pbc.crop_resize(torch.from_numpy(img), torch.from_numpy(boxes), out_hw,
                              method="nearest").numpy()
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", sorted(BOXES))
@pytest.mark.parametrize("out_hw", OUT_HW)
def test_crop_resize_bilinear(kind, out_hw):
    boxes = np.asarray(BOXES[kind], np.float32)
    img = images(2)
    want = np.asarray(jbc.crop_resize(jnp_t(img), jnp_t(boxes), out_hw, method="bilinear"))
    got = pbc.crop_resize(torch.from_numpy(img), torch.from_numpy(boxes), out_hw,
                          method="bilinear").numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=BILINEAR_ATOL)


def test_crop_resize_integer_input():
    """An integer map keeps its dtype nearest and comes out fp32 bilinear,
    as in the JAX package."""
    img = images(3, c=1, dtype=np.int32)
    boxes = np.asarray(BOXES["fractional"], np.float32)
    for method in ("nearest", "bilinear"):
        want = np.asarray(jbc.crop_resize(jnp_t(img), jnp_t(boxes), (9, 13), method=method))
        got = pbc.crop_resize(torch.from_numpy(img), torch.from_numpy(boxes), (9, 13),
                              method=method).numpy()
        assert str(got.dtype) == str(want.dtype)
        if method == "nearest":
            np.testing.assert_array_equal(got, want)
        else:   # ids up to 35000: a few fp32 roundings of the largest apart
            np.testing.assert_allclose(got, want, rtol=0, atol=35000 * 2.0**-21)


def test_crop_resize_pil_bicubic_raises():
    # pil_bicubic is ported (tests/test_torch_device_resident.py holds it
    # against the JAX package); an unknown method still raises, and a
    # degenerate window gives zeros, not a NaN
    with pytest.raises(ValueError, match="unknown crop_resize method"):
        pbc.crop_resize(torch.zeros(1, 4, 4, 3), torch.zeros(1, 4), (2, 2), method="bicubic")
    out = pbc.crop_resize(torch.ones(1, 4, 4, 3), torch.zeros(1, 4), (2, 2),
                          method="pil_bicubic")
    assert torch.equal(out, torch.zeros(1, 2, 2, 3))


@pytest.mark.parametrize("kind", sorted(BOXES))
@pytest.mark.parametrize("patch_hw", [(16, 16), (5, 9)])
@pytest.mark.parametrize("method", ["nearest", "bilinear"])
def test_paste_resize(kind, patch_hw, method):
    boxes = np.asarray(BOXES[kind], np.float32)
    canvas = images(4)
    patch = np.random.RandomState(5).uniform(-1, 1, size=(2, *patch_hw, 3)).astype(np.float32)
    want = np.asarray(jbc.paste_resize(jnp_t(canvas), jnp_t(patch), jnp_t(boxes), method=method))
    got = pbc.paste_resize(torch.from_numpy(canvas), torch.from_numpy(patch),
                           torch.from_numpy(boxes), method=method).numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    if method == "nearest":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=BILINEAR_ATOL)
    # outside the box the canvas passes through exactly
    outside = np.asarray(jbc.box_mask(jnp_t(boxes), HW))[..., 0] == 0
    np.testing.assert_array_equal(got[outside], canvas[outside])


@pytest.mark.parametrize("kind", sorted(BOXES))
def test_box_mask_bit_exact(kind):
    boxes = np.asarray(BOXES[kind], np.float32)
    want = np.asarray(jbc.box_mask(jnp_t(boxes), HW))
    got = pbc.box_mask(torch.from_numpy(boxes), HW).numpy()
    np.testing.assert_array_equal(got, want)
    img = images(6)
    np.testing.assert_array_equal(
        pbc.mask_box(torch.from_numpy(img), torch.from_numpy(boxes), fill=0.5).numpy(),
        np.asarray(jbc.mask_box(jnp_t(img), jnp_t(boxes), fill=0.5)))


@pytest.mark.parametrize("out_size", [32, 128, 512])
@pytest.mark.parametrize("margin", [1.5, 2.0, 3.0])
def test_expand_to_context_window_bit_exact(out_size, margin):
    rng = np.random.RandomState(out_size + int(10 * margin))
    hw = (256, 512)
    bh = rng.uniform(0.2, 300, size=64)
    bw = rng.uniform(0.2, 600, size=64)
    y0 = rng.uniform(-20, hw[0], size=64)
    x0 = rng.uniform(-20, hw[1], size=64)
    boxes = np.stack([y0, x0, bh, bw], axis=1).astype(np.float32)
    want = np.asarray(jbc.expand_to_context_window(jnp_t(boxes), hw, margin, out_size=out_size))
    got = pbc.expand_to_context_window(torch.from_numpy(boxes), hw, margin,
                                       out_size=out_size).numpy()
    np.testing.assert_array_equal(got, want)


def test_context_window_math_host_one_source():
    """The host dataset's rule is the compositing module's, and its numpy
    (float64) path equals the JAX package's numpy path."""
    assert pbbox.context_window_math is pbc.context_window_math
    rng = np.random.RandomState(11)
    for _ in range(100):
        hw = (int(rng.randint(32, 600)), int(rng.randint(32, 1200)))
        bh, bw = rng.rand() * hw[0] * 1.5, rng.rand() * hw[1] * 1.5
        y0, x0 = rng.uniform(-30, hw[0]), rng.uniform(-30, hw[1])
        scale, size = float(rng.choice([1.0, 2.0, 3.5])), int(rng.choice([32, 128, 512]))
        want = jbc.context_window_math(y0, x0, bh, bw, hw, scale, size, np)
        got = pbc.context_window_math(y0, x0, bh, bw, hw, scale, size, np)
        assert [float(v) for v in got] == [float(v) for v in want]
        # the host crop's integer window, as the bbox dataset takes it
        assert pbbox._context_window((y0, x0, bh, bw), hw, scale, size) == tuple(
            int(v) for v in want)
