"""The port's grain pipeline (``data/grain_pipeline.py``, ``--data_backend
grain``) against the JAX package's ``GrainLoader``, which runs the grain
package: the shuffle's order and seed, the batches of both dataset
families epoch by epoch, the iterator's state resume, ``first_batch`` and
``__len__``; then the port alone: its thread loader in serial mode, the
refusals of ``CreateDataLoader`` and both train CLIs with decode workers.

Two tests start worker processes: ``test_workers_match_in_process`` and
``test_train_clis_with_workers``."""

import hashlib
import os
import random
import re
import shutil

import numpy as np
import pytest
from PIL import Image

from neurips18_hierchical_image_manipulation_tpu.configs import options as jopts
from neurips18_hierchical_image_manipulation_tpu.data import loader as jloader
from neurips18_hierchical_image_manipulation_tpu_torch.cli import box2mask_train, mask2image_train
from neurips18_hierchical_image_manipulation_tpu_torch.configs import options as popts
from neurips18_hierchical_image_manipulation_tpu_torch.data import grain_pipeline as pgrain
from neurips18_hierchical_image_manipulation_tpu_torch.data import loader as ploader
from neurips18_hierchical_image_manipulation_tpu_torch.train import loop as ploop
from torch_port_helpers import restore_torch_precision  # noqa: F401  (fixture)

N_SCENES = 7   # 14 bbox windows: an odd count for drop_last


def write_dataroot(root, n=N_SCENES):
    """64x128 train scenes, two thing objects each, ids below 8."""
    rng = np.random.RandomState(0)
    for sub in ("label", "inst", "img"):
        (root / f"train_{sub}").mkdir(parents=True)
    for i in range(n):
        label = np.full((64, 128), 3, np.uint8)
        inst = label.astype(np.int32)
        for k in range(2):
            y, x = rng.randint(0, 40), rng.randint(0, 96)
            label[y : y + 20, x : x + 28] = 6
            inst[y : y + 20, x : x + 28] = 6000 + k
        img = rng.randint(0, 256, size=(64, 128, 3), dtype=np.uint8)
        Image.fromarray(label).save(root / "train_label" / f"{i:02d}.png")
        Image.fromarray(inst, mode="I").save(root / "train_inst" / f"{i:02d}.png")
        Image.fromarray(img).save(root / "train_img" / f"{i:02d}.png")


@pytest.fixture
def roots(tmp_path):
    """One dataroot a side (the bbox dataset caches its records in it)."""
    write_dataroot(tmp_path / "jax")
    shutil.copytree(tmp_path / "jax", tmp_path / "port")
    return tmp_path / "jax", tmp_path / "port"


FAMILIES = {
    "aligned": dict(use_bbox_dataset=False, resize_or_crop="scale_width_and_crop",
                    loadSize=96, fineSize=48, no_flip=False),
    "bbox": dict(use_bbox_dataset=True, fineSize=32, min_box_size=4, no_flip=False),
}


def make_opt(opts, root, family, **kw):
    opt = opts.MaskToImageTrainOptions(dataroot=str(root),
                                       **{"data_backend": "grain", **FAMILIES[family], **kw})
    opt.serial_batches = kw.get("serial_batches", False)
    return opt


def assert_batches_equal(a, b, roots):
    assert list(a) == list(b)
    for k in a:
        if isinstance(a[k], list):   # source paths, each under its own root
            rel = [[os.path.relpath(p, r) for p in x[k]] for x, r in zip((a, b), roots)]
            assert rel[0] == rel[1], k
        else:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def assert_runs_equal(xs, ys, roots):
    assert len(xs) == len(ys) >= 1
    for a, b in zip(xs, ys):
        assert_batches_equal(a, b, roots)


# (n, seed) pairs: n from 2 to 3000, seeds over the uint32 range
PAIRS = [(2, 0), (3, 1), (11, 0), (100, 7), (1000, 3), (3000, 2**32 - 1)]
_rng = random.Random(0)
PAIRS += [(_rng.randint(2, 3000), _rng.randint(0, 2**32 - 1)) for _ in range(44)]


@pytest.mark.parametrize("group", range(5))
def test_order_matches_grain(group):
    """index_shuffle and the derived seed against grain's, exact, over 50
    (n, seed) pairs; shuffled_order against index_shuffle."""
    pytest.importorskip("grain")
    import grain
    from grain._src.python.experimental.index_shuffle.python import (
        index_shuffle_module as gshuffle,
    )

    for n, seed in PAIRS[group::5]:
        want = [gshuffle.index_shuffle(i, max_index=n - 1, seed=seed, rounds=4)
                for i in range(n)]
        assert pgrain.shuffled_order(n, seed).tolist() == want, (n, seed)
        assert sorted(want) == list(range(n))
        for i in (0, n // 2, n - 1):
            assert pgrain.index_shuffle(i, n - 1, seed) == want[i], (n, seed, i)
        base = seed % 2**31
        node = grain.MapDataset.source(list(range(n))).seed(base).shuffle()
        assert pgrain.derived_seed(base) == node._seed, base


def test_order_past_the_smallest_block():
    """Blocks of 18 and 20 bits (n past 2**16), sampled positions."""
    pytest.importorskip("grain")
    from grain._src.python.experimental.index_shuffle.python import (
        index_shuffle_module as gshuffle,
    )

    for n, seed in ((70_000, 3), (300_000, 2**31 + 5)):
        order = pgrain.shuffled_order(n, seed)
        for i in range(0, n, n // 97):
            assert order[i] == gshuffle.index_shuffle(i, max_index=n - 1, seed=seed,
                                                      rounds=4), (n, i)


@pytest.mark.parametrize("family", sorted(FAMILIES))
@pytest.mark.parametrize("shuffle", [False, True])
def test_loader_matches_jax(roots, family, shuffle):
    """CreateDataLoader(--data_backend grain) on each side, two epochs at
    batch size 2: the same batches in the same order, epoch by epoch."""
    pytest.importorskip("grain")
    runs = []
    for opts, loader, root in ((jopts, jloader, roots[0]), (popts, ploader, roots[1])):
        ld = loader.CreateDataLoader(make_opt(opts, root, family, batchSize=2,
                                              serial_batches=not shuffle))
        runs.append([list(ld), list(ld)])
    assert len(runs[0][0]) in (3, 7)
    for epoch in (0, 1):
        assert_runs_equal(runs[0][epoch], runs[1][epoch], roots)
    # the epochs differ (a new order, or the aligned scenes' new crop draws)
    assert (not shuffle and family == "bbox") or any(not np.array_equal(a["label"], b["label"])
               for a, b in zip(runs[1][0], runs[1][1]))


@pytest.mark.parametrize("family", sorted(FAMILIES))
@pytest.mark.parametrize("k", [1, 3])
def test_state_resume_matches_jax(roots, family, k):
    """get_state after batch k, set_state on a fresh iterator: the port
    continues as the JAX iterator's own resume does, and as its own
    straight run."""
    pytest.importorskip("grain")
    rest = []
    for opts, loader, root in ((jopts, jloader, roots[0]), (popts, ploader, roots[1])):
        ld = loader.CreateDataLoader(make_opt(opts, root, family, batchSize=1))
        it = ld.epoch_iterator(1)
        for _ in range(k):
            next(it)
        state = it.get_state()
        straight = list(it)
        fresh = ld.epoch_iterator(1)
        fresh.set_state(state)
        resumed = list(fresh)
        assert_runs_equal(resumed, straight, (root, root))
        rest.append(resumed)
    assert pgrain.GrainLoader([0]).epoch_iterator(0).get_state() == {"next_index": 0}
    assert_runs_equal(rest[0], rest[1], roots)


@pytest.mark.parametrize("drop_last", [True, False])
def test_first_batch_and_len(roots, drop_last):
    """GrainLoader over each side's bbox dataset at batch size 4 (14
    windows): __len__, first_batch (no epoch consumed) and every batch,
    the partial last one too."""
    pytest.importorskip("grain")
    from neurips18_hierchical_image_manipulation_tpu.data import bbox as jbbox
    from neurips18_hierchical_image_manipulation_tpu.data import grain_pipeline as jgrain
    from neurips18_hierchical_image_manipulation_tpu_torch.data import bbox as pbbox

    loaders = []
    for opts, bbox, grain_mod, root in ((jopts, jbbox, jgrain, roots[0]),
                                        (popts, pbbox, pgrain, roots[1])):
        ds = bbox.BboxCropDataset(make_opt(opts, root, "bbox"))
        loaders.append(grain_mod.GrainLoader(ds, batch_size=4, seed=5, drop_last=drop_last))
    jl, pl = loaders
    assert len(pl) == len(jl) == (3 if drop_last else 4)
    assert_batches_equal(jl.first_batch(), pl.first_batch(), roots)
    assert pl._epoch == 0
    assert_runs_equal(list(jl), list(pl), roots)
    assert [len(b["path"]) for b in list(pl)] == [4, 4, 4] + ([] if drop_last else [2])


def test_workers_match_in_process(roots):
    """Two forked decode workers against the in-process path, and against
    the JAX loader at its in-process path: the aligned scenes (whose crops
    are drawn per epoch), shuffled, two epochs, and a set_state resume
    restarting the workers; a worker's exception raised at the consumer's
    next(). (Serial order and the bbox family at workers 0:
    test_loader_matches_jax, test_serial_grain_equals_thread_loader.)"""
    pytest.importorskip("grain")
    lds = [loader.CreateDataLoader(make_opt(opts, root, "aligned", batchSize=2,
                                            grain_workers=workers))
           for opts, loader, root, workers in ((jopts, jloader, roots[0], 0),
                                               (popts, ploader, roots[1], 0),
                                               (popts, ploader, roots[1], 2))]
    assert lds[2].num_workers == 2
    for _ in (0, 1):
        runs = [list(ld) for ld in lds]
        assert_runs_equal(runs[1], runs[2], (roots[1], roots[1]))
        assert_runs_equal(runs[0], runs[2], roots)
    # the workers' read-ahead is not the state: the consumer's count is
    it = lds[2].epoch_iterator(4)
    first = [next(it), next(it)]
    state = it.get_state()
    assert state == {"next_index": 2}
    it.close()
    fresh = lds[2].epoch_iterator(4)
    fresh.set_state(state)
    assert_runs_equal(first + list(fresh), list(lds[1].epoch_iterator(4)),
                      (roots[1], roots[1]))
    # a worker's exception reaches the consumer
    with pytest.raises(ValueError, match="sample 5 is broken"):
        list(pgrain.GrainLoader(Broken(), batch_size=2, num_workers=2))


class Broken:
    def __len__(self):
        return 8

    def __getitem__(self, i):
        if i == 5:
            raise ValueError("sample 5 is broken")
        return {"x": np.full(3, i, np.int32)}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_serial_grain_equals_thread_loader(roots, family):
    """In serial mode the grain backend yields the thread loader's batches."""
    runs = []
    for backend in ("threads", "grain"):
        ld = ploader.CreateDataLoader(make_opt(popts, roots[1], family, batchSize=2,
                                               serial_batches=True, data_backend=backend))
        runs.append(list(ld) + list(ld))
    assert isinstance(ld, pgrain.GrainLoader)
    assert_runs_equal(runs[0], runs[1], (roots[1], roots[1]))


@pytest.mark.parametrize("flags,match", [
    (dict(device_resident_data=True, grain_workers=4), "§C.15"),
    (dict(data_backend="tfdata"), "backends are threads and grain"),
])
def test_refusals(roots, flags, match):
    """C.15: the JAX package drops --data_backend grain under
    --device_resident_data without a word; the port refuses the pair. An
    unknown backend is refused too."""
    opt = make_opt(popts, roots[1], "aligned", gpu_ids="-1", **flags)
    with pytest.raises(ValueError, match=match):
        ploader.CreateDataLoader(opt)


def loss_lines(out):
    lines = [ln for ln in out.splitlines() if ln.startswith("(epoch: ")]
    vals = [dict(re.findall(r"(\w+): (-?[0-9.]+|nan|inf)", ln.split(") ", 1)[1]))
            for ln in lines]
    return [{k: v for k, v in d.items() if k != "img_per_s_per_chip"} for d in vals]


def test_train_clis_with_workers(tmp_path, capsys, monkeypatch, restore_torch_precision):
    """mask2image_train and box2mask_train for one epoch with --data_backend
    grain at --grain_workers 2 and 0 (mask2image also with --device_prefetch
    2): the same batches bit for bit (digests taken where the loop stages
    them) and the same loss lines."""
    digests = []
    orig = ploop.to_device

    def recording(hb, device):
        digests.append(hashlib.sha256(b"".join(
            np.ascontiguousarray(v).tobytes() for k, v in sorted(hb.items())
            if isinstance(v, np.ndarray))).hexdigest())
        return orig(hb, device)

    monkeypatch.setattr(ploop, "to_device", recording)
    write_dataroot(tmp_path / "city", n=1)
    arch = ["--label_nc", "8", "--ngf", "8", "--ndf", "8", "--n_downsample_global", "2",
            "--n_blocks_global", "1", "--n_layers_D", "2", "--fineSize", "32",
            "--min_box_size", "4", "--gpu_ids", "-1", "--niter", "1", "--niter_decay", "0",
            "--print_freq", "1", "--save_latest_freq", "1000", "--data_backend", "grain",
            "--dataroot", str(tmp_path / "city")]
    for cli, extra, prefetch in ((mask2image_train, ["--no_vgg_loss"], ("0", "2")),
                                 (box2mask_train, ["--bg_box_prob", "0.25"], ("0",))):
        runs = []
        for workers, depth in [("0", "0")] + [("2", d) for d in prefetch]:
            del digests[:]
            state = cli.main(["--name", f"w{workers}", "--checkpoints_dir",
                              str(tmp_path / cli.__name__ / workers / depth), "--grain_workers",
                              workers, "--device_prefetch", depth, *arch, *extra])
            runs.append((loss_lines(capsys.readouterr().out), list(digests)))
            assert state.step == 2
        (losses0, batches0), *others = runs
        assert len(losses0) == len(batches0) == 2
        for losses, batches in others:
            assert batches == batches0, cli.__name__
            assert losses == losses0, cli.__name__
