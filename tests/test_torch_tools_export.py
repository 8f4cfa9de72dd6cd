"""The port's ``tools/export_inference.py`` and the kernel ops of
``kernels/ops.py`` on the CPU.

  (f) a tiny box2mask and a tiny mask2image (the JAX-written stage runs of
      ``tests/test_torch_two_step_cli.py``, restored into the port): the
      exported graph holds the ``himan::`` op nodes; saved, loaded and
      rerun it gives the eager forward's bits; its output is within 1e-4
      of the JAX package's ``inference`` on the same parameters (the JAX
      export test is ``tests/test_export.py``).

Also both ops through ``torch.library.opcheck`` on CPU tensors (schema,
fake tensors, dispatch), each against its wrapper, eager calls that never
touch the ops, and the tool's refusal of a graph without them.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from neurips18_hierchical_image_manipulation_tpu.cli.mask2image_test import (
    restore_params as jax_restore_params,
)
from neurips18_hierchical_image_manipulation_tpu.configs import options as jopts
from neurips18_hierchical_image_manipulation_tpu.models.factory import (
    create_model as jax_create_model,
)
from neurips18_hierchical_image_manipulation_tpu.ops import nnops as jnnops
from neurips18_hierchical_image_manipulation_tpu_torch.configs import options as popts
from neurips18_hierchical_image_manipulation_tpu_torch.data.synthetic import (
    synthetic_batch,
    synthetic_box2mask_batch,
)
from neurips18_hierchical_image_manipulation_tpu_torch.kernels import encode as kenc
from neurips18_hierchical_image_manipulation_tpu_torch.kernels import instance_norm as kin
from neurips18_hierchical_image_manipulation_tpu_torch.kernels import ops as kops
from neurips18_hierchical_image_manipulation_tpu_torch.models.factory import create_model
from neurips18_hierchical_image_manipulation_tpu_torch.tools import export_inference
from neurips18_hierchical_image_manipulation_tpu_torch.utils.checkpoint import restore_params
from test_torch_two_step_cli import ARCH, write_stage_runs
from torch_port_helpers import restore_torch_precision  # noqa: F401  (fixture)

STAGES = {
    "box2mask": ("b2m_demo", jopts.BoxToMaskTestOptions, popts.BoxToMaskTestOptions,
                 lambda rng: synthetic_box2mask_batch(rng, 1, size=32, label_nc=8)),
    "mask2image": ("m2i_demo", jopts.MaskToImageTestOptions, popts.MaskToImageTestOptions,
                   lambda rng: synthetic_batch(rng, 1, hw=(32, 32), label_nc=8)),
}


@pytest.fixture(scope="module")
def stage_runs(tmp_path_factory):
    ckpt = str(tmp_path_factory.mktemp("export") / "ckpt")
    write_stage_runs(ckpt)
    return ckpt


def outputs(out):
    return list(out) if isinstance(out, (tuple, list)) else [out]


@pytest.mark.parametrize("stage", sorted(STAGES))
def test_export_holds_ops_reloads_bit_exact_and_matches_jax(stage, stage_runs, tmp_path,
                                                            restore_torch_precision):  # noqa: F811
    name, jcls, pcls, make_batch = STAGES[stage]
    opt = pcls(name=name, checkpoints_dir=stage_runs, gpu_ids="-1", **ARCH)
    model = create_model(opt)
    assert restore_params(opt, model)
    host = make_batch(np.random.RandomState(3))
    batch = {k: torch.from_numpy(v) for k, v in host.items()}

    ep = export_inference.export(stage, model, batch)
    ops = kops.exported_ops(ep.graph_module)
    # IN sites: box2mask 2 + 3 n_down + 2 n_blocks, the GlobalGenerator 1 + 2 n_down +
    # 2 n_blocks
    sites = 2 + 3 * 2 + 2 * 1 if stage == "box2mask" else 1 + 2 * 2 + 2 * 1
    assert ops == {kops.ENCODE: int(stage == "mask2image"), kops.INSTANCE_NORM: sites}
    path = str(tmp_path / f"{stage}.pt2")
    assert export_inference.save(ep, path) > 1000
    with torch.no_grad():
        eager = outputs(model.inference(batch))
        reloaded = outputs(export_inference.load(path).module()(batch))
    assert len(eager) == len(reloaded)
    for a, b in zip(eager, reloaded):
        assert a.dtype == b.dtype and torch.equal(a, b)

    jopt = jcls(name=name, checkpoints_dir=stage_runs, **ARCH)
    jmodel = jax_create_model(jopt)
    jbatch = {k: jnp.asarray(v) for k, v in host.items()}
    with jnnops.precision_scope():
        params = jax_restore_params(jopt, jmodel, jbatch)
        want = outputs(jmodel.inference(params, jbatch))
    for a, b in zip(reloaded, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4, rtol=0)


@pytest.mark.parametrize("stage", sorted(STAGES))
def test_exported_graph_holds_no_profiler_op(stage, stage_runs):
    """Exported under a running profiler, where ``inference``'s spans would
    record: the graph holds no profiler op (a span is off under export),
    and the eager call after it records its spans."""
    from neurips18_hierchical_image_manipulation_tpu_torch.train import profiler

    name, _, pcls, make_batch = STAGES[stage]
    model = create_model(pcls(name=name, checkpoints_dir=stage_runs, gpu_ids="-1", **ARCH))
    batch = {k: torch.from_numpy(v) for k, v in make_batch(np.random.RandomState(3)).items()}
    profiler.reset_spans()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        ep = export_inference.export(stage, model, batch)
        assert profiler.span_table() == {}
        model.inference(batch)
    targets = [str(n.target) for n in ep.graph_module.graph.nodes if n.op == "call_function"]
    assert targets and not [t for t in targets if "profiler" in t or "record_function" in t]
    assert {k: v["count"] for k, v in profiler.span_table().items()} == {
        "himan.infer": 1, "himan.infer.encode": 1, "himan.infer.G": 1}


def test_export_without_ops_refused(stage_runs, monkeypatch):
    """No fallback: a graph traced through the plain composition raises."""
    name, _, pcls, make_batch = STAGES["box2mask"]
    model = create_model(pcls(name=name, checkpoints_dir=stage_runs, gpu_ids="-1", **ARCH))
    batch = {k: torch.from_numpy(v) for k, v in make_batch(np.random.RandomState(3)).items()}
    monkeypatch.setattr(torch.compiler, "is_exporting", lambda: False)
    with pytest.raises(RuntimeError, match="lacks the kernel ops"):
        export_inference.export("box2mask", model, batch)


def test_export_cli_writes_program(tmp_path, capsys, monkeypatch):
    """The CLI's flags reach ``build`` (here at a tiny width: the stage's
    defaults are the full-width generators) and the program is written."""
    seen = []
    build = export_inference.build

    def tiny_build(stage, label_nc, fine_size, batch_size, gpu_ids):
        seen.append((stage, label_nc, fine_size, batch_size, gpu_ids))
        return build(stage, label_nc, fine_size, batch_size, gpu_ids,
                     ngf=8, n_downsample_global=2, n_blocks_global=1)

    monkeypatch.setattr(export_inference, "build", tiny_build)
    out = str(tmp_path / "b2m.pt2")
    _, n = export_inference.main(["--stage", "box2mask", "--out", out, "--label_nc", "8",
                                  "--fineSize", "32", "--gpu_ids", "-1"])
    assert seen == [("box2mask", 8, 32, 1, "-1")]
    assert os.path.getsize(out) == n
    assert f"exported box2mask inference: {n} bytes, device=cpu" in capsys.readouterr().out


def encode_args(image):
    rng = np.random.RandomState(0)
    label = torch.from_numpy(rng.randint(0, 6, (2, 9, 11)).astype(np.int32))
    inst = torch.from_numpy((rng.randint(0, 3, (2, 9, 11)) * 1000 + 26000).astype(np.int32))
    rgb = torch.from_numpy(rng.uniform(-1, 1, (2, 9, 11, 3)).astype(np.float32))
    boxes = torch.tensor([[1.0, 2.0, 4.0, 5.0], [0.0, 0.0, 9.0, 3.5]])
    return (label, inst, rgb, boxes) if image else (label, inst, None, None)


@pytest.mark.parametrize("image,pad", [(True, 3), (True, 0), (False, 0)])
def test_encode_op_checks_and_equals_wrapper(image, pad):
    label, inst, rgb, boxes = encode_args(image)
    args = (label, inst, rgb, boxes, 6, pad, None if image else torch.bfloat16)
    torch.library.opcheck(kops.encode, args)
    got = torch.ops.himan.encode(*args)
    assert torch.equal(got, kenc.encode(*args))
    assert torch.equal(got, kenc.encode_plain(*args))


@pytest.mark.parametrize("act,residual", [("none", False), ("relu", True), ("lrelu", False)])
def test_instance_norm_op_checks_and_equals_wrapper(act, residual):
    g = torch.Generator().manual_seed(1)
    x = torch.randn(2, 5, 7, 6, generator=g)
    res = torch.randn(2, 5, 7, 6, generator=g) if residual else None
    torch.library.opcheck(kops.instance_norm, (x, act, res, kin.EPS))
    got = torch.ops.himan.instance_norm(x, act, res, kin.EPS)
    for a, b in zip(got, kin.instance_norm_plain(x, act, res)):
        assert torch.equal(a, b)


def test_eager_calls_never_reach_the_ops(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("an eager call went through the op")

    monkeypatch.setattr(kops, "encode", refuse)
    monkeypatch.setattr(kops, "instance_norm", refuse)
    label, inst, rgb, boxes = encode_args(True)
    kenc.encode(label, inst, rgb, boxes, 6, 3)
    kin.instance_norm_act(torch.randn(1, 4, 4, 8), "relu")


def test_ops_refuse_another_device():
    """The ops' implementation (their wrappers) on a device that is neither
    the card nor the CPU."""
    x = torch.randn(1, 4, 4, 8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        kops.instance_norm._init_fn(x, "none", None, kin.EPS)
    label = torch.zeros(1, 4, 4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        kops.encode._init_fn(label, None, None, None, 6, 0, None)
