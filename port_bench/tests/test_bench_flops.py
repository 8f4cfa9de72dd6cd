"""The analytic FLOP count against the convolutions the port dispatches.

The port's ``tools/roofline_step.py --collect`` records every convolution
one mask2image train step dispatches (forward, data gradient, weight
gradient) under a ``TorchDispatchMode``. At the CPU tests' widths the
benchmark's count (``port_bench/flops.py``) equals it apart from the three
differences that file lists: the port's split first D layer
(``port_differences``), the collector's JAX form of a data gradient, and
its tap past a transposed convolution's last input.
"""

import types

import pytest

from port_bench import flops


def _true_flops(rec):
    """A record's true MACs x 2, as the forward of its convolution counts
    them: output positions x taps, taps on zero padding included; a
    transposed 3x3 stride-2 convolution 3m - 1 real taps an axis."""
    n, cin, h, w = rec["input_shape"]
    k = rec["weight_shape"]
    if rec["transposed"]:
        return 2.0 * n * k[0] * k[1] * (3 * h - 1) * (3 * w - 1)
    cout, _, kh, kw = k
    (sh, sw), (ph, pw) = rec["stride"], rec["padding"]
    ho, wo = (h + 2 * ph - kh) // sh + 1, (w + 2 * pw - kw) // sw + 1
    return 2.0 * n * ho * wo * cout * cin * kh * kw


@pytest.fixture(scope="module")
def collected():
    rs = pytest.importorskip("neurips18_hierchical_image_manipulation_tpu_torch.tools.roofline_step")
    args = types.SimpleNamespace(bs=2, dtype="float32", smoke=True, gpu_ids="-1")
    opt, model, batch, cdt = rs.flagship(args)
    doc = rs.collect(opt, model, batch, cdt)
    cfg = dict(rs.SMOKE, model="pix2pixHD")
    return doc, flops.train_step(cfg, args.bs, rs.SMOKE_HW, 4), \
        flops.port_differences(cfg, args.bs, rs.SMOKE_HW)


def _by_kind(doc, fn):
    out = {}
    for r in doc["convs"]:
        out[r["kind"]] = out.get(r["kind"], 0.0) + fn(r) * r["count"]
    return out


@pytest.mark.parametrize("kind", ["fwd", "wgrad", "dgrad"])
def test_count_equals_dispatched_convolutions(collected, kind):
    doc, count, port_diff = collected
    dispatched = _by_kind(doc, lambda r: r["flops"])[kind]
    true = _by_kind(doc, _true_flops)[kind]
    # the collector's conventions: a data gradient in JAX's form, the tap past
    # a transposed convolution's last input
    convention = dispatched - true
    if kind == "fwd":
        assert convention > 0          # the transposed convolutions' extra tap
    expected = count[f"conv_{kind}"] - (port_diff / 2 if kind != "dgrad" else 0.0)
    assert true == pytest.approx(expected, rel=1e-12)


def test_port_difference_is_the_split_first_layer(collected):
    doc, count, port_diff = collected
    assert port_diff > 0
    assert count["conv"] == pytest.approx(
        count["conv_fwd"] + count["conv_wgrad"] + count["conv_dgrad"], rel=1e-15)


def test_serving_forward_is_g_alone():
    cfg = dict(model="pix2pixHD", label_nc=35, ngf=64, n_downsample_global=4,
               n_blocks_global=9)
    # the published GlobalGenerator at 512x512: 493.9 GFLOP a forward
    assert flops.g_forward(cfg, 1, (512, 512)) == pytest.approx(493.88068864e9, rel=1e-9)
