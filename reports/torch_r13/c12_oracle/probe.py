"""C.12 probe: the flagship procedural recipe trained by the
reference-equivalent PyTorch step instead of the port's.

    python reports/torch_r13/c12_oracle/probe.py --seed 0 --out DIR [--gpu_ids 0]

The recipe is the port's ``tools/train_dynamics`` flagship run in the fp32
parity tier (TF32 off): ``make_world``'s 256 procedural 512x256 scenes,
bs 16, 2000 steps (125 epochs of 16, LR constant for 62 then linear decay
over 63, a step at a time), no masked image, resident uint8 data. What
differs is only the train step: ``tools/bench_torch_oracle.Oracle``
(pix2pixHD's modules in plain PyTorch, ``F.mse_loss`` / ``F.l1_loss``,
``torch.optim.Adam``), which launches no port kernel and runs no port
network module.

  * Same init: the port's G, D and VGG as ``create_model`` draws them for
    ``--seed``, carried into the oracle by ``pix2pixhd_format``'s
    state-dict maps (``bench_torch_oracle.load_port_init``).
  * Same batches: the port's resident sampler for ``--seed``
    (``train/steps._resident_batches``: the epoch permutation of (seed,
    epoch), the draws of (seed, step)). The oracle builds its input with
    plain torch; at step 1 it is held equal, bit for bit, to the port's
    encode (the G input without its stem pad, and D's conditioning).
  * Before the long run the oracle is held to the port's fp32
    ``make_train_step`` from the same init over the same batches: every
    loss of step 1 (one set of parameters: the same forward function)
    within CHECK_RTOL, or the probe stops. Beside it, recorded against
    their bars: every G and D gradient at the init (max |diff| / max |g| of
    each leaf) and every loss of steps 2 .. ``--check_steps``, each bar the
    larger of CHECK_RTOL and CHECK_SPREAD times the port's own difference
    between two runs of the same steps (cuDNN's fp32 algorithms are not
    deterministic, and Adam's first update, sign(g) * lr, flips wherever a
    gradient sits at rounding level). On the card the port's gradients are
    over their bar: its multiscale D's input gradient is wrong there (the
    CUDA AvgPool2d backward of a channels_last view, ``pool_grad.py`` beside
    this script; ROADMAP §C.12), while the oracle's matches an fp64
    reference, so the oracle is the reference step and the long run goes on.

Writes ``DIR/loss_log.json`` (each epoch's last step, as the train CLI's
loss line) and ``DIR/summary.json``: G_GAN_Feat first, min (epoch) and
last, D_real / D_fake last, the epoch from which G_GAN_Feat stays above 3,
the check, the wall clock, the card's name and power limit.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import sys
import tempfile
import time
from types import SimpleNamespace

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__)))))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from neurips18_hierchical_image_manipulation_tpu_torch.configs.options import (  # noqa: E402
    MaskToImageTrainOptions,
    check_train_options,
    parse_cli,
)
from neurips18_hierchical_image_manipulation_tpu_torch.data.loader import (  # noqa: E402
    CreateDataLoader,
)
from neurips18_hierchical_image_manipulation_tpu_torch.kernels.calls import (  # noqa: E402
    read_launches,
)
from neurips18_hierchical_image_manipulation_tpu_torch.models.factory import (  # noqa: E402
    create_model,
)
from neurips18_hierchical_image_manipulation_tpu_torch.tools import (  # noqa: E402
    bench_torch_oracle as bo,
)
from neurips18_hierchical_image_manipulation_tpu_torch.tools import (  # noqa: E402
    roofline_step as rs,
)
from neurips18_hierchical_image_manipulation_tpu_torch.tools import (  # noqa: E402
    train_dynamics,
)
from neurips18_hierchical_image_manipulation_tpu_torch.train.schedule import (  # noqa: E402
    linear_decay_factor,
)
from neurips18_hierchical_image_manipulation_tpu_torch.train.state import (  # noqa: E402
    make_optimizers,
)
from neurips18_hierchical_image_manipulation_tpu_torch.train.steps import (  # noqa: E402
    _resident_batches,
    make_train_step,
)

CHECK_RTOL = 1e-4     # the losses at one set of parameters, fp32, another summation order
CHECK_SPREAD = 2.0    # past step 1: of the port's own run-to-run difference (cuDNN's
                      # fp32 algorithms are not deterministic, and Adam's first update,
                      # sign(g) * lr, flips where a gradient sits at rounding level)
KEYS = ("G_GAN", "G_GAN_Feat", "G_VGG", "D_real", "D_fake")


def recipe_argv(args, world, ckpt):
    """``tools/train_dynamics``'s flagship train-CLI flags, fp32."""
    spe = args.n_images // args.bs
    epochs = max(args.steps // spe, 1)
    niter = max(epochs // 2, 1)
    return ["--name", "c12", "--dataroot", world, "--checkpoints_dir", ckpt,
            "--label_nc", "35", "--ngf", "64", "--ndf", "64", "--n_downsample_global", "4",
            "--n_blocks_global", "9", "--num_D", "2", "--n_layers_D", "3",
            "--batchSize", str(args.bs), "--resize_or_crop", "none", "--no_flip",
            "--no-use_bbox_dataset", "--no-use_masked_image", "--uint8_transfer",
            "--device_resident_data", "--dtype", "float32", "--niter", str(niter),
            "--niter_decay", str(epochs - niter), "--seed", str(args.seed),
            "--gpu_ids", args.gpu_ids, *args.arch.split()]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--steps", type=int, default=2000)
    p.add_argument("--bs", type=int, default=16)
    p.add_argument("--n_images", type=int, default=256)
    p.add_argument("--check_steps", type=int, default=3)
    p.add_argument("--world", default=os.path.join(tempfile.gettempdir(), "himan_c12_world"))
    p.add_argument("--gpu_ids", default="0")
    p.add_argument("--arch", default="",
                   help="train-CLI flags appended to the recipe's, one string (tiny CPU "
                   "rehearsals)")
    p.add_argument("--hw", default="256,512", help="the world's scene size")
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    t0 = time.time()
    if not os.path.exists(os.path.join(args.world, "train_label")):
        train_dynamics.make_world(args.world, args.n_images,
                                  hw=tuple(int(v) for v in args.hw.split(",")))
    opt = parse_cli(MaskToImageTrainOptions,
                    recipe_argv(args, args.world, tempfile.mkdtemp(prefix="himan_c12_")))
    check_train_options(opt)
    loader = CreateDataLoader(opt)
    model = create_model(opt)   # the fp32 parity tier: TF32 off
    device = model.device
    spe = len(loader)
    sample_fn, data = loader.fused_sampler()
    batch_of = _resident_batches(model, sample_fn, loader.n_samples, opt.batchSize,
                                 not opt.serial_batches, opt.seed, (0, opt.batchSize), None)
    init = {net: {k: v.detach().clone() for k, v in m.state_dict().items()}
            for net, m in model.nets().items()}
    nc = opt.label_nc
    lam = functools.partial(linear_decay_factor, niter=opt.niter, niter_decay=opt.niter_decay,
                            steps_per_epoch=spe)

    def restore_init():
        for net, m in model.nets().items():
            m.load_state_dict(init[net])

    def make_oracle():
        restore_init()
        o = bo.Oracle(nc + 1, nc + 1, opt.ngf, opt.n_downsample_global, opt.n_blocks_global,
                      opt.ndf, opt.n_layers_D, opt.num_D, lr=opt.lr, beta1=opt.beta1,
                      lambda_feat=opt.lambda_feat, lr_lambda=lam, device=device)
        bo.load_port_init(o, model)
        return o

    def inputs(k):
        x, cond, real = bo.oracle_inputs(batch_of(SimpleNamespace(step=k), data), nc,
                                         masked_image=False)
        return x, cond, real

    # the input at step 1, against the port's encode
    b0 = batch_of(SimpleNamespace(step=0), data)
    x, cond, _ = inputs(0)
    g_in = model.encode_input(b0)
    g_in = g_in.padded[:, 3:-3, 3:-3] if hasattr(g_in, "padded") else g_in
    same_input = bool(torch.equal(g_in.permute(0, 3, 1, 2), x)
                      and torch.equal(model._cond(model._normalized(b0)).permute(0, 3, 1, 2),
                                      cond))
    if not same_input:
        raise AssertionError("the oracle's input is not the port's encode at step 1")

    # the gradients at the init: the port's twice, the oracle's, by
    # pix2pixHD key (pix2pixhd_format's maps applied to the gradients)
    def port_grads():
        restore_init()
        for m in model.nets().values():
            m.zero_grad(set_to_none=True)
        model.losses(b0)[0].backward()
        return oracle_keys({net: {k: (p.grad if p.grad is not None else torch.zeros_like(p))
                                  for k, p in m.named_parameters()}
                            for net, m in model.nets().items() if net in ("G", "D")})

    def oracle_keys(sds):
        g = model.netG
        out = {f"G.{k}": v for k, v in bo.p2p.global_generator_state_dict(
            sds["G"], g.n_downsampling, g.n_blocks, inner="block").items()}
        d = bo.p2p.multiscale_discriminator_state_dict(sds["D"], opt.num_D, opt.n_layers_D,
                                                       spelling="scale{i}_layer{n}")
        for i in range(opt.num_D):
            j = opt.num_D - 1 - i
            out.update({f"Ds.{i}.stages.{n}.0.{leaf}": d[f"scale{j}_layer{n}.0.{leaf}"]
                        for n in range(opt.n_layers_D + 2) for leaf in ("weight", "bias")})
        return out

    def grad_diff(a, b):
        """max over leaves of max |a - b| / max |b|, and the share of the
        elements of nonzero b whose sign a does not share (Adam's first
        update is sign(g) * lr)."""
        worst, flips, n = 0.0, 0, 0
        for k, gb in b.items():
            ga, scale = a[k], float(gb.abs().max())
            if scale == 0.0:
                continue   # a dead bias (IN removes it): no gradient in the port
            worst = max(worst, float((ga - gb).abs().max()) / scale)
            nz = gb != 0
            flips += int((torch.sign(ga[nz]) != torch.sign(gb[nz])).sum())
            n += int(nz.sum())
        return {"max_rel": worst, "sign_flip_share": flips / max(n, 1)}

    grads_a, grads_b = port_grads(), port_grads()
    oracle = make_oracle()
    loss_g, loss_d, _ = oracle.losses(*inputs(0))
    (loss_g + loss_d).backward()
    grads_o = {f"G.{k}": p.grad for k, p in oracle.G.named_parameters()}
    grads_o.update({f"Ds.{k}": p.grad for k, p in oracle.Ds.named_parameters()})
    # D's gradient from G's loss is dropped before D's step in pix2pixHD's
    # order: D's own gradient is that of loss_D alone
    oracle.opt_d.zero_grad(set_to_none=True)
    oracle.losses(*inputs(0))[1].backward()
    grads_o.update({f"Ds.{k}": p.grad for k, p in oracle.Ds.named_parameters()})
    grads = {"port_vs_port": grad_diff(grads_b, grads_a),
             "oracle_vs_port": grad_diff(grads_o, grads_a)}
    print(f"[check gradients at the init] {json.dumps(grads)}", flush=True)
    del grads_a, grads_b, grads_o

    # the first steps: the port's fp32 make_train_step twice (its cuDNN
    # algorithms are not deterministic in fp32: the second run is the spread
    # a port run carries) and the oracle, from the init over the same batches
    def port_run():
        restore_init()
        step, state = make_train_step(model, None), make_optimizers(opt, model, spe)
        return [{k: float(v) for k, v in step(state, batch_of(SimpleNamespace(step=k),
                                                              data))[0].items()}
                for k in range(args.check_steps)]

    def rel(a, b):
        return max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-12) for k in KEYS)

    port_a, port_b = port_run(), port_run()
    oracle = make_oracle()
    orc = [{k: float(v) for k, v in oracle.step(*inputs(k)).items()}
           for k in range(args.check_steps)]
    check = []
    for k in range(args.check_steps):
        spread = rel(port_b[k], port_a[k])
        row = {"step": k + 1, "port": port_a[k], "port_again": port_b[k], "oracle": orc[k],
               "oracle_vs_port": rel(orc[k], port_a[k]), "port_vs_port": spread,
               "bar": max(CHECK_RTOL, CHECK_SPREAD * spread) if k else CHECK_RTOL}
        check.append(row)
        print(f"[check step {k + 1}] " + json.dumps(row), flush=True)
    if check[0]["oracle_vs_port"] > CHECK_RTOL:
        raise AssertionError(f"step 1's losses, oracle against the port: {check[0]}")
    grads["bar"] = max(CHECK_RTOL, CHECK_SPREAD * grads["port_vs_port"]["max_rel"])
    over = ([f"step {r['step']}" for r in check if r["oracle_vs_port"] > r["bar"]]
            + (["gradients"] if grads["oracle_vs_port"]["max_rel"] > grads["bar"] else []))
    if over:
        print(f"[check] over their bars, oracle against the port: {over}", flush=True)
    worst = max(r["oracle_vs_port"] for r in check)

    # the long run, from the same init
    oracle = make_oracle()
    del model
    if device.type == "cuda":
        torch.cuda.empty_cache()
    launches = read_launches()
    log, t1 = [], time.time()
    for k in range(args.steps):
        m = oracle.step(*inputs(k))
        if (k + 1) % spe == 0:
            row = {"epoch": (k + 1) // spe, "step": k + 1, **{key: float(m[key]) for key in KEYS}}
            log.append(row)
            print(json.dumps(row), flush=True)
    if read_launches() != launches:
        raise AssertionError("the oracle's run launched port kernels")
    feat = [r["G_GAN_Feat"] for r in log]
    i_min = min(range(len(feat)), key=feat.__getitem__)
    above = None
    for i in range(len(feat) - 1, -1, -1):
        if feat[i] <= 3.0:
            break
        above = log[i]["epoch"]
    summary = {
        "seed": args.seed, "steps": args.steps, "bs": args.bs, "epochs_logged": len(log),
        "tier": "fp32, cudnn.allow_tf32 %s" % torch.backends.cudnn.allow_tf32,
        "same_input_at_step_1": same_input, "check": check, "check_worst_rel": worst,
        "check_over_bar": over,
        "check_gradients_at_init": grads,
        "G_GAN_Feat": {"first": feat[0], "min": feat[i_min], "min_epoch": log[i_min]["epoch"],
                       "last": feat[-1]},
        "G_GAN_Feat_above_3_from_epoch": above,
        "first": log[0], "last": log[-1],
        "finite": all(all(v == v and abs(v) != float("inf") for v in r.values()) for r in log),
        "device": rs.device_line(device), "train_s": time.time() - t1, "wall_s": time.time() - t0,
    }
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "loss_log.json"), "w") as f:
        json.dump(log, f, indent=1)
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps({k: v for k, v in summary.items() if k != "check"}), flush=True)
    return summary


if __name__ == "__main__":
    main()
