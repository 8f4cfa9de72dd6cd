"""The port's two-step pipeline (``eval/two_step.py``) against the JAX
package's on the CPU, from the same weights: the JAX fixture of
``tests/test_two_step.py`` (label_nc 8, ngf 8, 2 downs, 1 resblock,
fineSize 32, 64x96 scenes, ``init_params`` at PRNGKey 0 / 1) carried into
the port through the npz sidecar.

For add, remove and swap every output key is held to the JAX pipeline's:
the integer maps and the windows exactly, except at pixels where the JAX
fill's top-two margin is below 1e-5 (a near-tie that the two packages'
softmaxes may break either way; counted, and the count asserted);
object_mask, window_rgb and edited_image within 1e-4; outside the box,
every output passes its input through exactly. Also the committed golden
``tests/goldens/two_step_add.npz`` under the JAX test's own bands, remove's
null class, swap's consumption of the edited instance map, and each
stage's own TF32 setting."""

import os

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from neurips18_hierchical_image_manipulation_tpu.ops import boxcomposite as jbc
from neurips18_hierchical_image_manipulation_tpu.utils.checkpoint import save_params_npz
from neurips18_hierchical_image_manipulation_tpu_torch.configs import options as popts
from neurips18_hierchical_image_manipulation_tpu_torch.eval.two_step import TwoStepPipeline
from neurips18_hierchical_image_manipulation_tpu_torch.models import factory
from neurips18_hierchical_image_manipulation_tpu_torch.models.factory import create_model
from neurips18_hierchical_image_manipulation_tpu_torch.utils.checkpoint import (
    state_dicts_from_jax,
)
from test_e2e_golden import _ssim
from test_two_step import make_scene, pipeline  # noqa: F401  (the JAX fixture)
from torch_port_helpers import restore_torch_precision  # noqa: F401  (fixture)

ARCH = dict(label_nc=8, ngf=8, n_downsample_global=2, n_blocks_global=1, fineSize=32)
FLOAT_ATOL = 1e-4
TIE_MARGIN = 1e-5
# the edits of tests/test_two_step.py: (mode, boxes, new boxes, cls)
EDITS = {
    "add": ([[20.0, 30.0, 24.0, 24.0]], None, 6),
    "remove": ([[10.0, 10.0, 16.0, 20.0]], None, 0),
    "swap": ([[10.0, 10.0, 16.0, 16.0]], [[30.0, 50.0, 20.0, 20.0]], 5),
}
INT_KEYS = ("completed_label", "edited_inst", "window_layout", "window_inst")
FLOAT_KEYS = ("object_mask", "window_rgb", "edited_image")


def port_stages(jpipe, tmp, b2m_kw=None, m2i_kw=None, b2m_first=True):
    """Port models of the JAX fixture's architecture, with its weights,
    created in the order asked for."""
    make = {
        "b2m": lambda: create_model(popts.BoxToMaskTestOptions(gpu_ids="-1", **ARCH,
                                                               **(b2m_kw or {}))),
        "m2i": lambda: create_model(popts.MaskToImageTestOptions(
            gpu_ids="-1", use_masked_image=True, **ARCH, **(m2i_kw or {}))),
    }
    order = ("b2m", "m2i") if b2m_first else ("m2i", "b2m")
    made = {name: make[name]() for name in order}
    b2m, m2i = made["b2m"], made["m2i"]
    for model, params, name in ((b2m, jpipe.b2m_params, "b2m"), (m2i, jpipe.m2i_params, "m2i")):
        path = os.path.join(tmp, f"{name}.npz")
        save_params_npz(path, {"G": params["G"]})
        with np.load(path) as f:
            sd = state_dicts_from_jax({k: f[k] for k in f.files})["G"]
        model.netG.load_state_dict(sd, strict=True)
    return b2m, m2i


@pytest.fixture(scope="module")
def port_pipeline(pipeline, tmp_path_factory):  # noqa: F811
    prev = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    b2m, m2i = port_stages(pipeline, str(tmp_path_factory.mktemp("two_step")))
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev
    return TwoStepPipeline(b2m, m2i)


def scene():
    image, label, inst = make_scene(np.random.RandomState(0))
    return np.array(image), np.array(label), np.array(inst)


def run_jax(jpipe, mode, image, label, inst):
    boxes, new_boxes, cls = EDITS[mode]
    args = [jnp.asarray(a) for a in (image, label, inst)]
    cls = jnp.asarray([cls], jnp.int32)
    if mode == "add":
        out = jpipe.add_object(*args, jnp.asarray(boxes), cls)
    elif mode == "remove":
        out = jpipe.remove_object(*args, jnp.asarray(boxes))
    else:
        out = jpipe.swap_object(*args, jnp.asarray(boxes), jnp.asarray(new_boxes), cls)
    return {k: np.asarray(v) for k, v in out.items()}


def run_port(ppipe, mode, image, label, inst):
    boxes, new_boxes, cls = EDITS[mode]
    args = [torch.from_numpy(a) for a in (image, label, inst)]
    cls = torch.tensor([cls], dtype=torch.int32)
    boxes = torch.tensor(boxes)
    if mode == "add":
        out = ppipe.add_object(*args, boxes, cls)
    elif mode == "remove":
        out = ppipe.remove_object(*args, boxes)
    else:
        out = ppipe.swap_object(*args, boxes, torch.tensor(new_boxes), cls)
    return {k: v.numpy() for k, v in out.items()}


def jax_near_ties(jpipe, mode, image, label, inst, boxes, cls):
    """The pixels of one JAX pass whose fill the structure generator's top
    two probabilities decide by less than TIE_MARGIN: in its window, in the
    full map (through the nearest paste of the window layout) and in the
    image generator's window (through its nearest crop)."""
    s, ms = jpipe.crop_size, jpipe.m2i_size
    hw = label.shape[1:3]
    boxes = jnp.asarray(boxes, jnp.float32)
    windows = jbc.expand_to_context_window(boxes, hw, jpipe.margin, out_size=s)
    label_win = jbc.crop_resize(jnp.asarray(label)[..., None].astype(jnp.float32), windows,
                                (s, s), method="nearest")[..., 0].astype(jnp.int32)
    wy0, wx0, wh, ww = (windows[:, k] for k in range(4))
    box_in_win = jnp.stack([(boxes[:, 0] - wy0) * (s / wh), (boxes[:, 1] - wx0) * (s / ww),
                            boxes[:, 2] * (s / wh), boxes[:, 3] * (s / ww)], axis=1)
    boxmask = jbc.box_mask(box_in_win, (s, s))
    g_cls = jnp.full((1,), -1 if mode == "remove" else cls, jnp.int32)
    merged, _, ctx = jpipe.b2m.inference(
        jpipe.b2m_params, {"masked_layout": label_win, "boxmask": boxmask, "cls": g_cls},
        return_ctx=True)
    top2 = np.sort(np.asarray(ctx if mode == "remove" else merged), axis=-1)[..., -2:]
    near_win = ((top2[..., 1] - top2[..., 0]) < TIE_MARGIN) & (np.asarray(boxmask)[..., 0] > 0)
    pasted = jbc.paste_resize(jnp.zeros((1, *hw, 1)), jnp.asarray(near_win, jnp.float32)[..., None],
                              windows, method="nearest")[..., 0]
    near_full = (np.asarray(pasted) > 0) & (np.asarray(jbc.box_mask(boxes, hw))[..., 0] > 0)
    near_m2i = np.asarray(jbc.crop_resize(jnp.asarray(near_full, jnp.float32)[..., None], windows,
                                          (ms, ms), method="nearest"))[..., 0] > 0
    return {"window_layout": near_win, "completed_label": near_full, "edited_inst": near_full,
            "window_inst": near_m2i}


@pytest.fixture(scope="module")
def outputs(pipeline, port_pipeline):  # noqa: F811
    """Both pipelines' outputs for each edit, and the JAX near-tie pixels
    of its last pass (swap: the add pass; its remove pass is held too)."""
    image, label, inst = scene()
    out = {}
    for mode in EDITS:
        j, p = run_jax(pipeline, mode, image, label, inst), run_port(port_pipeline, mode, image,
                                                                      label, inst)
        boxes, new_boxes, cls = EDITS[mode]
        if mode == "swap":
            first = {k: np.asarray(v) for k, v in pipeline.remove_object(
                *(jnp.asarray(a) for a in (image, label, inst)), jnp.asarray(boxes)).items()}
            near_first = jax_near_ties(pipeline, "remove", image, label, inst, boxes, 0)
            near = jax_near_ties(pipeline, "add", first["edited_image"], first["completed_label"],
                                 first["edited_inst"], new_boxes, cls)
            near = {k: v | (near_first[k] if k in ("completed_label", "edited_inst") else False)
                    for k, v in near.items()}
        else:
            near = jax_near_ties(pipeline, mode, image, label, inst, boxes, cls)
        out[mode] = (j, p, near)
    return (image, label, inst), out


@pytest.mark.parametrize("mode", sorted(EDITS))
@pytest.mark.parametrize("key", INT_KEYS + ("windows",))
def test_integer_outputs_match_jax(outputs, mode, key):
    _, out = outputs
    j, p, near = out[mode]
    assert p[key].shape == j[key].shape and str(p[key].dtype) == str(j[key].dtype)
    if key == "windows":
        np.testing.assert_array_equal(p[key], j[key])
        return
    differ = p[key] != j[key]
    # the seeded scene has no near-tie pixel: every map is exact
    assert near[key].sum() == 0
    assert not (differ & ~near[key]).any(), f"{mode} {key}: {differ.sum()} pixels differ"


@pytest.mark.parametrize("mode", sorted(EDITS))
@pytest.mark.parametrize("key", FLOAT_KEYS)
def test_float_outputs_match_jax(outputs, mode, key):
    _, out = outputs
    j, p, _ = out[mode]
    assert p[key].shape == j[key].shape and p[key].dtype == j[key].dtype
    np.testing.assert_allclose(p[key], j[key], rtol=0, atol=FLOAT_ATOL)


@pytest.mark.parametrize("mode", sorted(EDITS))
def test_outside_box_passthrough_exact(outputs, mode):
    (image, label, inst), out = outputs
    _, p, _ = out[mode]
    boxes, new_boxes, _ = EDITS[mode]
    boxes = boxes if new_boxes is None else boxes + new_boxes
    inside = np.zeros(label.shape, bool)
    for b in boxes:
        inside |= np.asarray(jbc.box_mask(jnp.asarray([b]), label.shape[1:3]))[..., 0] > 0
    for key, ref in (("completed_label", label), ("edited_inst", inst), ("edited_image", image)):
        assert np.abs(p[key][~inside].astype(np.float64) - ref[~inside]).max() == 0.0, key
    # and something was rendered inside
    assert not np.array_equal(p["edited_image"][inside], image[inside])


def test_golden_two_step_add(port_pipeline):
    """tests/goldens/two_step_add.npz, under tests/test_e2e_golden.py's
    bands: the completed label exact, the edited image within 2e-3, SSIM
    above 0.999."""
    g = np.load(os.path.join(os.path.dirname(__file__), "goldens", "two_step_add.npz"))
    out = run_port(port_pipeline, "add", *scene())
    np.testing.assert_array_equal(out["completed_label"], g["completed"])
    np.testing.assert_allclose(out["edited_image"], g["edited"], atol=2e-3)
    assert _ssim(out["edited_image"], g["edited"]) > 0.999


def test_remove_mode_null_class(port_pipeline):
    """remove conditions the structure generator on the all-zero class
    vector of id -1, never on class 0, a real class."""
    b2m = port_pipeline.b2m
    batch = {"masked_layout": torch.zeros((1, 32, 32), dtype=torch.int32),
             "boxmask": torch.zeros((1, 32, 32, 1)), "cls": torch.tensor([-1])}
    assert b2m.encode_input(batch)[2].abs().sum() == 0
    batch["cls"] = torch.tensor([0])
    assert b2m.encode_input(batch)[2].abs().sum() > 0
    seen = []
    orig = b2m.inference
    b2m.inference = lambda batch, **kw: seen.append(batch["cls"].clone()) or orig(batch, **kw)
    try:
        out = run_port(port_pipeline, "remove", *scene())
    finally:
        del b2m.inference
    assert [c.tolist() for c in seen] == [[-1]]
    assert np.isfinite(out["edited_image"]).all()


def test_swap_consumes_edited_inst(port_pipeline):
    """remove's edited_inst erases the removed object's id inside the box
    (ids follow the completed label there), so swap's add pass sees no
    ghost edge; swap's add pass is fed exactly that map."""
    image, label, inst = scene()
    inst = inst.copy()
    inst[0, 14:22, 14:26] = 5 * 1000 + 7
    args = [torch.from_numpy(a) for a in (image, label, inst)]
    out = port_pipeline.remove_object(*args, torch.tensor([[10.0, 10.0, 16.0, 20.0]]))
    ei = out["edited_inst"][0].numpy()
    assert (ei[10:26, 10:30] != 5 * 1000 + 7).all()
    np.testing.assert_array_equal(ei[10:26, 10:30], out["completed_label"][0, 10:26, 10:30].numpy())
    np.testing.assert_array_equal(ei[:10], inst[0, :10])

    fed = []
    orig = port_pipeline.manipulate
    port_pipeline.manipulate = lambda *a, **kw: fed.append(a[2]) or orig(*a, **kw)
    try:
        port_pipeline.swap_object(*args, torch.tensor([[10.0, 10.0, 16.0, 20.0]]),
                                  torch.tensor([[30.0, 50.0, 20.0, 20.0]]),
                                  torch.tensor([5], dtype=torch.int32))
    finally:
        del port_pipeline.manipulate
    assert len(fed) == 2
    np.testing.assert_array_equal(fed[1].numpy(), ei[None])


@pytest.mark.parametrize("b2m_first", [True, False])
def test_mixed_tier_stage_scoping(pipeline, tmp_path, restore_torch_precision, b2m_first):  # noqa: F811
    """A b2m stage at --conv_precision default (TF32) and an m2i stage at
    highest, created in either order: each stage's inference runs under its
    own TF32 switches, whichever stage create_model built last, and the
    caller's switches are put back."""
    b2m_kw, m2i_kw = {"conv_precision": "default"}, {"conv_precision": "highest"}
    b2m, m2i = port_stages(pipeline, str(tmp_path), b2m_kw, m2i_kw, b2m_first)
    assert b2m.conv_precision_resolved == "default" and m2i.conv_precision_resolved == "highest"
    seen = {}

    def spy(name, model):
        orig = model.inference

        def inference(*a, **kw):
            seen[name] = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
            return orig(*a, **kw)
        model.inference = inference

    spy("b2m", b2m)
    spy("m2i", m2i)
    caller = (True, False)   # a setting neither stage has
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = caller
    run_port(TwoStepPipeline(b2m, m2i), "add", *scene())
    assert seen == {"b2m": (True, True), "m2i": (False, False)}
    assert (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32) == caller
    with factory.precision_scope(b2m):
        assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32
    assert (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32) == caller
