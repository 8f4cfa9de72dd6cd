"""The port's evaluators against the JAX package's, on the CPU: the metric
functions of ``eval/metrics.py`` and ``eval/two_step_metrics.py`` on seeded
arrays (exact, the linear algebra within 1e-10), and both stages of the
evaluate CLI on one tiny dataroot from the same JAX-written sidecars
(box2mask mIoU and consistency within 1e-6; FID within 1e-3 relative, with
one shared ``--feature_params`` file)."""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from neurips18_hierchical_image_manipulation_tpu.cli import evaluate as jax_eval
from neurips18_hierchical_image_manipulation_tpu.eval import metrics as jm
from neurips18_hierchical_image_manipulation_tpu.eval import two_step_metrics as jtm
from neurips18_hierchical_image_manipulation_tpu.models.networks import Vgg19Features as JaxVgg
from neurips18_hierchical_image_manipulation_tpu.ops import nnops as jnnops
from neurips18_hierchical_image_manipulation_tpu.utils.checkpoint import save_params_npz
from neurips18_hierchical_image_manipulation_tpu_torch.cli import evaluate as port_eval
from neurips18_hierchical_image_manipulation_tpu_torch.eval import metrics as pm
from neurips18_hierchical_image_manipulation_tpu_torch.eval import two_step_metrics as ptm
from neurips18_hierchical_image_manipulation_tpu_torch.models import networks
from test_cli import common_flags, dataroot  # noqa: F401  (fixture)
from test_torch_two_step_cli import write_stage_runs
from torch_port_helpers import restore_torch_precision  # noqa: F401  (fixture)

LINALG_ATOL = 1e-10


def labels(seed, shape=(2, 16, 24), nc=6):
    return np.random.RandomState(seed).randint(0, nc, size=shape)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_layout_metrics_match_jax(seed):
    pred, gt = labels(seed), labels(seed + 10)
    gt[0] = pred[0]
    mask = np.random.RandomState(seed).rand(2, 16, 24, 1) > 0.5
    for ignore_empty in (True, False):
        assert pm.layout_miou(pred, gt, 8, ignore_empty) == jm.layout_miou(pred, gt, 8, ignore_empty)
    assert pm.pixel_accuracy(pred, gt) == jm.pixel_accuracy(pred, gt)
    assert pm.pixel_accuracy(pred, gt, mask[..., 0]) == jm.pixel_accuracy(pred, gt, mask[..., 0])
    for m in (mask, mask[..., 0]):
        assert pm.segmentation_consistency(pred, gt, m) == jm.segmentation_consistency(pred, gt, m)


@pytest.mark.parametrize("seed", [0, 1])
def test_fid_linear_algebra_matches_jax(seed):
    rng = np.random.RandomState(seed)
    feats = [rng.randn(20, 6) + k for k in range(2)]
    stats = []
    for mod in (pm, jm):
        rs = [mod.RunningStats(6) for _ in feats]
        for r, f in zip(rs, feats):
            r.update(f[:7])
            r.update(f[7:])
        stats.append([r.finalize() for r in rs])
    for (pmu, pcov), (jmu, jcov) in zip(*stats):
        np.testing.assert_allclose(pmu, jmu, rtol=0, atol=LINALG_ATOL)
        np.testing.assert_allclose(pcov, jcov, rtol=0, atol=LINALG_ATOL)
    a = rng.randn(6, 6)
    np.testing.assert_allclose(pm._sqrtm_psd(a @ a.T), jm._sqrtm_psd(a @ a.T), rtol=0,
                               atol=LINALG_ATOL)
    (mu1, s1), (mu2, s2) = stats[1]
    assert abs(pm.fid_from_stats(mu1, s1, mu2, s2) - jm.fid_from_stats(mu1, s1, mu2, s2)) <= LINALG_ATOL


def test_fid_evaluator_matches_jax():
    """The same features through both evaluators: one value."""
    rng = np.random.RandomState(3)
    real = rng.rand(16, 8, 8, 3).astype(np.float32)
    fake = rng.rand(16, 8, 8, 3).astype(np.float32) * 0.5 + 0.2
    pev = pm.FIDEvaluator(lambda x: x.mean(dim=(1, 2)), 3)
    jev = jm.FIDEvaluator(lambda x: jnp.mean(x, axis=(1, 2)), 3)
    pev.update(real_images=torch.from_numpy(real), fake_images=torch.from_numpy(fake))
    jev.update(real_images=real, fake_images=fake)
    assert abs(pev.compute() - jev.compute()) <= 1e-6 * abs(jev.compute())
    with pytest.raises(ValueError, match="2 samples"):
        pm.RunningStats(3).finalize()


def test_two_step_metrics_match_jax():
    rng = np.random.RandomState(4)
    gt = rng.randint(0, 5, size=(32, 48))
    pred = np.where(rng.rand(32, 48) > 0.3, gt, rng.randint(0, 5, size=(32, 48)))
    img = rng.rand(32, 48, 3)
    leaked = img + (rng.rand(32, 48, 3) > 0.99) * 0.5
    for box in ((8, 10, 16, 24), (0, 0, 32, 48), (-4, 40, 12.6, 20.4), (5, 5, 0, 0)):
        assert ptm.outside_box_max_abs(leaked, img, box) == jtm.outside_box_max_abs(leaked, img, box)
        assert ptm.outside_box_max_abs(pred, gt, box) == jtm.outside_box_max_abs(pred, gt, box)
        for fn, args in ((ptm.inbox_accuracy, ()), (ptm.inbox_class_iou, (3,)),
                         (ptm.inbox_miou, ([0, 1, 2, 3, 4, 9],))):
            got = fn(pred, gt, box, *args)
            want = getattr(jtm, fn.__name__)(pred, gt, box, *args)
            assert got == want or (np.isnan(got) and np.isnan(want)), (fn.__name__, box)
    vals = [0.25, float("nan"), 0.75, 0.123456]
    assert ptm.summarize(vals) == jtm.summarize(vals)
    assert ptm.summarize([float("nan")]) == jtm.summarize([float("nan")])


def vgg_params_file(path):
    """A VGG19 weights file in the layout the JAX evaluator reads: its
    ``vgg.init`` tree, ``params/conv{b}_{c}/{kernel,bias}``, drawn at He
    scale so that relu5_1 of a 32x32 window is not all but zero."""
    with jnnops.precision_scope():
        tree = JaxVgg().init(jax.random.PRNGKey(7), jnp.zeros((1, 32, 32, 3)))
    rng = np.random.RandomState(7)

    def draw(a):
        if a.ndim == 4:
            return rng.randn(*a.shape).astype(np.float32) * np.sqrt(2.0 / (9 * a.shape[2]))
        return (0.05 * rng.randn(*a.shape)).astype(np.float32)

    save_params_npz(path, jax.tree_util.tree_map(draw, tree))
    return path


def eval_flags(dataroot, tmp, name):  # noqa: F811
    return common_flags(dataroot, tmp, name) + ["--fineSize", "32", "--min_box_size", "4",
                                                "--phase", "test", "--how_many", "2"]


@pytest.mark.parametrize("stage", ["box2mask", "mask2image"])
def test_port_evaluate_matches_jax(dataroot, tmp_path, capsys, restore_torch_precision,  # noqa: F811
                                   stage):
    tmp = str(tmp_path)
    ckpt = os.path.join(tmp, "ckpt")
    write_stage_runs(ckpt)
    name = "b2m_demo" if stage == "box2mask" else "m2i_demo"
    extra = []
    if stage == "mask2image":
        extra = ["--feature_params", vgg_params_file(os.path.join(tmp, "vgg.npz"))]
    with jnnops.precision_scope():
        want = jax_eval.main(["--stage", stage, *extra] + eval_flags(dataroot, tmp, name))
    got = port_eval.main(["--stage", stage, *extra] + eval_flags(dataroot, tmp, name)
                         + ["--gpu_ids", "-1"])
    out = capsys.readouterr().out
    assert "restored checkpoint 'latest'" in out and "partial load" not in out
    assert got["metric"] == want["metric"] and got["samples"] == want["samples"] == 2
    if stage == "box2mask":
        assert abs(got["value"] - want["value"]) <= 1e-6
        assert abs(got["segmentation_consistency"] - want["segmentation_consistency"]) <= 1e-6
    else:
        assert np.isfinite(got["value"]) and got["value"] > 0
        assert abs(got["value"] - want["value"]) <= 1e-3 * abs(want["value"])


def test_feature_params_of_another_layout_refused(tmp_path):
    """The port reads the layout the JAX evaluator reads and no other: a
    file keyed ``VGG/params/...`` (tools/load_vgg_weights.py's output) does
    not load, as it does not into the JAX ``load_params_npz``."""
    path = vgg_params_file(str(tmp_path / "vgg.npz"))
    with np.load(path) as f:
        np.savez(str(tmp_path / "prefixed.npz"), **{f"VGG/{k}": f[k] for k in f.files})
    vgg = networks.Vgg19Features()
    port_eval.load_vgg(path, vgg)
    with pytest.raises(RuntimeError, match="Missing key"):
        port_eval.load_vgg(str(tmp_path / "prefixed.npz"), networks.Vgg19Features())
