"""``--tf_log`` in the port: the ``Visualizer`` writes TensorBoard scalars and
images as the JAX package's ``Visualizer`` does (read back from both event
files with tensorboard's ``EventAccumulator``), and the train CLI runs with
the flag on the CPU."""

import os

import numpy as np
from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

from neurips18_hierchical_image_manipulation_tpu.configs.options import (
    MaskToImageTrainOptions as JaxTrainOptions,
)
from neurips18_hierchical_image_manipulation_tpu.utils.visualizer import (
    Visualizer as JaxVisualizer,
)
from neurips18_hierchical_image_manipulation_tpu_torch.cli import mask2image_train
from neurips18_hierchical_image_manipulation_tpu_torch.configs.options import (
    MaskToImageTrainOptions,
)
from neurips18_hierchical_image_manipulation_tpu_torch.utils.visualizer import Visualizer
from test_torch_train_cli import ARCH, LOSSES, dataroot  # noqa: F401  (fixture)
from torch_port_helpers import restore_torch_precision  # noqa: F401  (fixture)

ERRORS = [(3, {"G_GAN": 0.5, "G_GAN_Feat": 1.25, "D_real": 0.125}),
          (7, {"G_GAN": 0.25, "G_GAN_Feat": 1.0625, "D_real": 0.375})]


def read_events(logdir):
    acc = EventAccumulator(logdir, size_guidance={"images": 0, "scalars": 0})
    acc.Reload()
    scalars = {tag: [(e.step, e.value) for e in acc.Scalars(tag)]
               for tag in acc.Tags()["scalars"]}
    return scalars, sorted(acc.Tags()["images"])


def drive(vis):
    rng = np.random.RandomState(0)
    for step, errors in ERRORS:
        vis.plot_current_errors(errors, step)
    visuals = {"input_label": rng.randint(0, 255, (8, 12, 3)).astype(np.uint8),
               "synthesized_image": rng.randint(0, 255, (8, 12, 3)).astype(np.uint8)}
    vis.display_current_results(visuals, epoch=1, step=7)
    vis.writer.flush()


def test_tf_log_matches_jax_visualizer(tmp_path):
    jopt = JaxTrainOptions(name="tb", checkpoints_dir=str(tmp_path / "jax"), tf_log=True,
                           no_html=True)
    jopt.parse()
    drive(JaxVisualizer(jopt))
    topt = MaskToImageTrainOptions(name="tb", checkpoints_dir=str(tmp_path / "port"),
                                   tf_log=True, no_html=True)
    drive(Visualizer(topt))
    want = read_events(str(tmp_path / "jax" / "tb" / "logs"))
    got = read_events(str(tmp_path / "port" / "tb" / "logs"))
    assert got == want
    assert sorted(got[0]) == ["D_real", "G_GAN", "G_GAN_Feat"]
    assert got[1] == ["input_label", "synthesized_image"]


def test_train_cli_tf_log_on_cpu(dataroot, tmp_path, restore_torch_precision):  # noqa: F811
    ckpt = str(tmp_path / "ckpt")
    mask2image_train.main([
        "--name", "tb", "--dataroot", dataroot, "--checkpoints_dir", ckpt, "--gpu_ids", "-1",
        "--niter", "1", "--niter_decay", "0", "--print_freq", "1", "--display_freq", "1",
        "--nThreads", "1", "--tf_log", *ARCH,
    ])
    scalars, images = read_events(os.path.join(ckpt, "tb", "logs"))
    # the loss line's throughput is plotted too, from the second step on
    assert sorted(scalars) == sorted(LOSSES) + ["img_per_s_per_chip"]
    steps = [s for s, _ in scalars["G_GAN"]]
    assert steps == list(range(1, len(steps) + 1)) and steps
    assert all(np.isfinite(v) for tag in scalars for _, v in scalars[tag])
    assert images
