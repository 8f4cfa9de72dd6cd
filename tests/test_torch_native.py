"""The port's C++ data tier (``data/native.py``, ``csrc/dataio.cpp``)
against its numpy forms (``data/hostops.py``) and the JAX package's tier,
bit for bit, on random maps; built with g++ from the port's own source."""

import os

import numpy as np
import pytest

from neurips18_hierchical_image_manipulation_tpu.data import native as jnative
from neurips18_hierchical_image_manipulation_tpu_torch.data import hostops, native


def test_native_tier_builds_from_the_port_source():
    assert native.available(), native.build_error
    assert native.tier() == "native"
    path = native.lib_path()
    assert os.path.exists(path) and os.path.dirname(path) == native.BUILD_DIR
    assert os.path.basename(native.SOURCE) == "dataio.cpp"
    assert native.SOURCE.startswith(native.PKG_DIR)   # not the JAX package's native/


@pytest.mark.parametrize("n_objects", [0, 7, 300, 1000])   # past the 256-record buffer
def test_extract_bboxes_matches_hostops(n_objects):
    rng = np.random.RandomState(n_objects)
    inst = rng.randint(0, 1000, (96, 128)).astype(np.int32)   # stuff ids, below min_id
    for k in range(n_objects):
        y, x = rng.randint(0, 96), rng.randint(0, 128)
        h, w = rng.randint(1, 12), rng.randint(1, 12)
        inst[y:y + h, x:x + w] = 24000 + 1000 * (k % 10) + k // 10
    got = native.extract_bboxes(inst)
    want = hostops.extract_bboxes(inst)
    assert got == want
    assert got == jnative.extract_bboxes(inst)
    assert len(got) == len(np.unique(inst[inst >= 1000]))


@pytest.mark.parametrize("shape,out", [((16, 24), (8, 12)), ((37, 53), (100, 7)),
                                       ((64, 96), (64, 96)), ((3, 5), (96, 128)),
                                       ((512, 1024), (512, 512))])
def test_nearest_resize_matches_hostops(shape, out):
    arr = np.random.RandomState(1).randint(-5, 70000, shape).astype(np.int32)
    got = native.nearest_resize_i32(arr, *out)
    np.testing.assert_array_equal(got, hostops.nearest_resize_i32(arr, *out))
    assert got.dtype == np.int32 and got.shape == out


def test_u8_to_pm1_bits():
    img = np.random.RandomState(2).randint(0, 256, (31, 17, 3)).astype(np.uint8)
    got = native.u8_to_pm1(img)
    want = hostops.u8_to_pm1(img)
    assert got.dtype == np.float32 and got.shape == img.shape
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    np.testing.assert_array_equal(native.u8_to_pm1(np.arange(256, dtype=np.uint8)).view(np.int32),
                                  hostops.u8_to_pm1(np.arange(256, dtype=np.uint8)).view(np.int32))


@pytest.mark.parametrize("box", [(2, 3, 4, 5), (0, 0, 10, 12), (7, 9, 30, 30), (9, 11, 1, 1)])
def test_box_mask_matches_hostops(box):
    got = native.box_mask_f32(10, 12, *box)
    np.testing.assert_array_equal(got, hostops.box_mask_f32(10, 12, *box))
    assert got.shape == (10, 12, 1) and got.dtype == np.float32


def test_bbox_dataset_uses_the_native_tier(monkeypatch):
    """The bbox records go through the native tier when it is built."""
    from neurips18_hierchical_image_manipulation_tpu_torch.data import bbox

    calls = []
    orig = native.extract_bboxes

    def counted(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    monkeypatch.setattr(native, "extract_bboxes", counted)
    inst = np.zeros((40, 40), np.int32)
    inst[4:24, 6:30] = 26001
    assert bbox.bboxes_from_instance_map(inst, min_size=4) == hostops.extract_bboxes(inst)
    assert calls == [1]
