"""Offline instance-feature encoding and clustering (pix2pixHD's
encode_features step; counterpart of the JAX repository's
``tools/encode_features.py``): run a trained ``--instance_feat`` run's
Encoder over the train set and write the per-class cluster centers that
``mask2image_test --instance_feat --cluster_path`` paints.

    python -m neurips18_hierchical_image_manipulation_tpu_torch.tools.encode_features \\
        --name NAME --dataroot DIR [--n_clusters 10] [--gpu_ids -1 for the CPU] \\
        --out features_clustered_010.npy

Takes the train options of the run (its architecture flags, ``--which_epoch``)
and reads ``{checkpoints_dir}/{name}/ckpt/{which_epoch}_params.npz``.
"""

from __future__ import annotations

import argparse

import numpy as np

from ..configs.options import MaskToImageTrainOptions, parse_cli
from ..data.loader import CreateDataLoader
from ..eval.features import cluster_features, encode_dataset_features
from ..models.factory import create_model
from ..utils.checkpoint import restore_params


def main(argv=None):
    extra = argparse.ArgumentParser(add_help=False)
    extra.add_argument("--out", default="features_clustered_010.npy")
    ns, rest = extra.parse_known_args(argv)
    opt = parse_cli(MaskToImageTrainOptions, rest)
    opt.instance_feat = True
    # the Encoder and G are restored; D and VGG19 are not needed
    opt.isTrain = False
    loader = CreateDataLoader(opt)
    model = create_model(opt)
    restore_params(opt, model)
    feats = encode_dataset_features(model, loader)
    clusters = cluster_features(feats, opt.label_nc, opt.n_clusters, opt.feat_num)
    np.save(ns.out, clusters)
    print(f"wrote {ns.out}: {clusters.shape} centers from "
          f"{sum(len(v) for v in feats.values())} instances")
    return clusters


if __name__ == "__main__":
    main()
