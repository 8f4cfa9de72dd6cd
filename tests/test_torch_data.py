"""The port's own copies of the host data pipeline against the JAX
package's: the numpy host ops, the context-window rule, and the aligned
and bbox-crop datasets and loader over one synthetic PNG dataroot."""

import os
import shutil

import numpy as np
import pytest
from PIL import Image

from neurips18_hierchical_image_manipulation_tpu.configs import options as jopts
from neurips18_hierchical_image_manipulation_tpu.data import loader as jloader
from neurips18_hierchical_image_manipulation_tpu.data import native as jnative
from neurips18_hierchical_image_manipulation_tpu.ops import boxcomposite as jbox
from neurips18_hierchical_image_manipulation_tpu_torch.configs import options as popts
from neurips18_hierchical_image_manipulation_tpu_torch.data import bbox as pbbox
from neurips18_hierchical_image_manipulation_tpu_torch.data import hostops
from neurips18_hierchical_image_manipulation_tpu_torch.data import loader as ploader


def inst_map(seed, h=40, w=56):
    """Stuff ids below 1000 and a few overlapping thing blobs."""
    rng = np.random.RandomState(seed)
    inst = rng.randint(0, 30, size=(h, w)).astype(np.int32)
    for k in range(4):
        y0, x0 = rng.randint(0, h - 4), rng.randint(0, w - 4)
        inst[y0 : y0 + rng.randint(2, 20), x0 : x0 + rng.randint(2, 30)] = 26000 + k
    return inst


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_hostops_match_jax_native(seed):
    inst = inst_map(seed)
    assert hostops.extract_bboxes(inst) == jnative.extract_bboxes(inst)
    rng = np.random.RandomState(seed)
    u8 = rng.randint(0, 256, size=(5, 7, 3)).astype(np.uint8)
    np.testing.assert_array_equal(hostops.u8_to_pm1(u8), jnative.u8_to_pm1(u8))
    for oh, ow in ((17, 23), (80, 112), (40, 56)):
        np.testing.assert_array_equal(
            hostops.nearest_resize_i32(inst, oh, ow), jnative.nearest_resize_i32(inst, oh, ow)
        )
    for box in ((3, 4, 10, 20), (-2, -3, 6, 9), (30, 50, 40, 40)):
        np.testing.assert_array_equal(
            hostops.box_mask_f32(40, 56, *box), jnative.box_mask_f32(40, 56, *box)
        )


def test_context_window_matches_jax():
    rng = np.random.RandomState(3)
    for _ in range(50):
        hw = (int(rng.randint(32, 600)), int(rng.randint(32, 1200)))
        bh, bw = rng.rand() * hw[0], rng.rand() * hw[1]
        y0, x0 = rng.rand() * (hw[0] - bh), rng.rand() * (hw[1] - bw)
        scale, size = float(rng.choice([1.0, 2.0, 3.5])), int(rng.choice([64, 256, 512]))
        want = jbox.context_window_math(y0, x0, bh, bw, hw, scale, size, np)
        got = pbbox.context_window_math(y0, x0, bh, bw, hw, scale, size)
        assert [float(v) for v in got] == [float(v) for v in want]


def write_dataroot(root, n=3, h=64, w=128):
    rng = np.random.RandomState(0)
    for sub in ("test_label", "test_inst", "test_img"):
        (root / sub).mkdir(parents=True)
    for i in range(n):
        label = np.full((h, w), 7, np.uint8)
        inst = label.astype(np.int32)
        for k in range(2):
            y0, x0 = rng.randint(0, h - 24), rng.randint(0, w - 40)
            label[y0 : y0 + 24, x0 : x0 + 40] = 26
            inst[y0 : y0 + 24, x0 : x0 + 40] = 26000 + k
        img = rng.randint(0, 256, size=(h, w, 3), dtype=np.uint8)
        Image.fromarray(label).save(root / "test_label" / f"{i}.png")
        Image.fromarray(inst, mode="I").save(root / "test_inst" / f"{i}.png")
        Image.fromarray(img).save(root / "test_img" / f"{i}.png")


def assert_batches_equal(a, b, roots):
    assert sorted(a) == sorted(b)
    for k in a:
        if isinstance(a[k], list):  # source paths, each under its own root
            rel = [[os.path.relpath(p, r) for p in x[k]] for x, r in zip((a, b), roots)]
            assert rel[0] == rel[1], k
        else:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize(
    "bbox,flags",
    [
        (True, dict(fineSize=48)),
        (False, dict(resize_or_crop="scale_width_and_crop", loadSize=96, fineSize=48)),
        (False, dict(resize_or_crop="none", uint8_transfer=True)),
    ],
)
def test_loader_matches_jax(tmp_path, bbox, flags):
    """Each side reads its own copy of the dataroot (the bbox dataset
    caches its records there) and yields the same batches."""
    write_dataroot(tmp_path / "jax")
    shutil.copytree(tmp_path / "jax", tmp_path / "port")
    batches = []
    for side, opts, loader in (("jax", jopts, jloader), ("port", popts, ploader)):
        opt = opts.MaskToImageTestOptions(
            dataroot=str(tmp_path / side), use_bbox_dataset=bbox, **flags
        )
        opt.serial_batches, opt.batchSize, opt.no_flip = False, 2, False
        batches.append(list(loader.CreateDataLoader(opt)))
    assert len(batches[0]) == len(batches[1]) >= 1
    for a, b in zip(*batches):
        assert_batches_equal(a, b, (tmp_path / "jax", tmp_path / "port"))
