"""The port's generator-input build (kernels/encode.py) against the JAX
package's Pallas encode kernels (interpret mode) and its jnp composition.
Every comparison is bit-exact: the build only compares and selects."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from neurips18_hierchical_image_manipulation_tpu.ops import boxcomposite as jbox
from neurips18_hierchical_image_manipulation_tpu.ops import nnops as jnnops
from neurips18_hierchical_image_manipulation_tpu.ops import onehot_edges as joh
from neurips18_hierchical_image_manipulation_tpu.ops.pallas import encode as jenc
from neurips18_hierchical_image_manipulation_tpu_torch.kernels import encode as kenc

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture
def interpret():
    old = jenc.INTERPRET
    jenc.INTERPRET = True
    yield
    jenc.INTERPRET = old


def make_inputs(nc, shape=(2, 12, 16), seed=0):
    """Random ids (with out-of-range ones), instance blobs, an image, and
    boxes: one at the top-left border, one running past the bottom-right."""
    rng = np.random.RandomState(seed)
    b, h, w = shape
    label = rng.randint(0, nc, size=shape).astype(np.int32)
    label[0, 0, :4] = [-1, nc, nc + 1, 255]
    inst = rng.randint(0, 4, size=shape).astype(np.int32)
    inst[:, h // 2 :, w // 2 :] = 26001
    image = (rng.rand(b, h, w, 3) * 2 - 1).astype(np.float32)
    image[1, 0, 0, 0] = -0.0
    boxes = np.array([[0, 0, 5, 7], [h - 4, w - 5, 10, 10.5]], np.float32)[:b]
    return label, inst, image, boxes


def bits(a):
    a = np.asarray(a)
    return a.view(np.uint16 if a.dtype.itemsize == 2 else np.uint32)


def torch_bits(t):
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy().view(np.uint32)


def port(label, inst, image, boxes, nc, pad, tdt):
    img = None if image is None else torch.from_numpy(image).to(tdt)
    bx = None if boxes is None else torch.from_numpy(boxes)
    return kenc.encode(
        torch.from_numpy(label), torch.from_numpy(inst), img, bx, nc, pad=pad, dtype=tdt
    )


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("nc", [8, 35])
def test_encode_full_matches_pallas(interpret, nc, dt):
    jdt, tdt = DTYPES[dt]
    label, inst, image, boxes = make_inputs(nc)
    want = jenc.encode_full(
        jnp.asarray(label), jnp.asarray(inst), jnp.asarray(image).astype(jdt),
        jnp.asarray(boxes), nc, jdt,
    )
    got = port(label, inst, image, boxes, nc, 0, tdt)
    assert tuple(got.shape) == want.shape and got.dtype == tdt
    np.testing.assert_array_equal(torch_bits(got), bits(want))


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("nc", [8, 35])
def test_encode_padded_matches_d2s2_packed(interpret, nc, dt):
    """Pad-3 mode == depth-to-space of the packed stem input."""
    jdt, tdt = DTYPES[dt]
    label, inst, image, boxes = make_inputs(nc)
    packed = jenc.encode_packed(
        jnp.asarray(label), jnp.asarray(inst), jnp.asarray(image).astype(jdt),
        jnp.asarray(boxes), nc, jdt,
    )
    want = jnnops.d2s2(packed)
    got = port(label, inst, image, boxes, nc, 3, tdt)
    assert tuple(got.shape) == want.shape == (2, 18, 22, nc + 4)
    np.testing.assert_array_equal(torch_bits(got), bits(want))


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("nc", [8, 35])
def test_encode_full_matches_jnp_composition(nc, dt):
    """Against onehot_edges.encode_input_rgb ∘ boxcomposite.mask_box."""
    jdt, tdt = DTYPES[dt]
    label, inst, image, boxes = make_inputs(nc, seed=1)
    masked = jbox.mask_box(jnp.asarray(image).astype(jdt), jnp.asarray(boxes), fill=0.0)
    want = joh.encode_input_rgb(jnp.asarray(label), jnp.asarray(inst), masked, nc, dtype=jdt)
    got = port(label, inst, image, boxes, nc, 0, tdt)
    np.testing.assert_array_equal(torch_bits(got), bits(want))


def test_encode_cond_matches_pallas(interpret):
    """No image: the one-hot ⊕ edge conditioning (encode_cond)."""
    nc = 8
    label, inst, _, _ = make_inputs(nc, shape=(2, 32, 16), seed=2)
    want = jenc.encode_cond(jnp.asarray(label), jnp.asarray(inst), nc, jnp.float32)
    got = port(label, inst, None, None, nc, 0, torch.float32)
    np.testing.assert_array_equal(torch_bits(got), bits(want))


def test_encode_no_instance_matches_jnp():
    nc = 8
    label, _, image, boxes = make_inputs(nc, seed=3)
    masked = jbox.mask_box(jnp.asarray(image), jnp.asarray(boxes), fill=0.0)
    want = joh.encode_input_rgb(jnp.asarray(label), None, masked, nc)
    got = kenc.encode(
        torch.from_numpy(label), None, torch.from_numpy(image),
        torch.from_numpy(boxes), nc,
    )
    np.testing.assert_array_equal(torch_bits(got), bits(want))


def test_encode_rejects_bad_inputs():
    label, inst, image, boxes = (torch.from_numpy(a) for a in make_inputs(8))
    with pytest.raises(ValueError):
        kenc.encode(label.to(torch.int64), inst, image, boxes, 8)
    with pytest.raises(ValueError):
        kenc.encode(label, inst, image.double(), boxes, 8)
    with pytest.raises(ValueError):
        kenc.encode(label, inst, image, boxes, 8, pad=2)
    with pytest.raises(ValueError):
        kenc.encode(label, inst, image, None, 8)
    with pytest.raises(ValueError):
        kenc.encode(label, inst, image.permute(0, 2, 1, 3), boxes, 8)


def test_encode_cpu_uses_plain_without_launch():
    launches = kenc.encode.launches
    label, inst, image, boxes = (torch.from_numpy(a) for a in make_inputs(8))
    kenc.encode(label, inst, image, boxes, 8, pad=3)
    assert kenc.encode.launches == launches
