"""Step-level attainability roofline of the flagship train step on one CUDA card.

    python -m neurips18_hierchical_image_manipulation_tpu_torch.tools.roofline_step \\
        --collect --bench [--dtype bfloat16|float32] [--bs 32] [--out FILE]

Counterpart of ``tools/roofline_step.py`` in the JAX package. The step is
BASELINE.json config 3: the mask2image GAN at 512x256 (GlobalGenerator at
ngf 64, 4 downs, 9 resblocks; 2-scale 3-layer PatchGAN; VGG19; LSGAN + FM +
VGG; both Adams), masked RGB, bs 32, in the bf16 tier over fp32 masters
(``--dtype float32``: the fp32 parity tier), through the port's
``train/steps.make_train_step``.

``--collect`` runs one step (after one warm-up step) under a
``TorchDispatchMode`` and writes ``--specs``: every convolution the step
dispatched, forward (``aten.convolution``) and backward
(``aten.convolution_backward``, split by its output mask into a dgrad and
a wgrad spec), with its multiplicity, shapes, strides and memory layouts,
dtype, transposition, the ``nn.Module`` that ran it, and its true-MAC FLOPs
(``_conv_flops``: the JAX tool's count on the JAX form of each spec, so a
transposed convolution counts as the lhs-dilated convolution it is); the
bytes of every other aten op (each distinct tensor read or written once;
views move none); and the port kernels' bytes, which no dispatch mode sees
(they launch through ``ctypes``), from their wrappers' arguments by
``kernels/bounds.call_bytes``. It runs on the device ``--gpu_ids`` names:
the card for the flagship, the CPU (``-1``) at ``--smoke`` widths.

``--bench`` reads ``--specs`` and, on the same device and under the step's
own switches (its tier's dtype and TF32 setting, cuDNN's default
algorithm choice):

  * times every spec standalone on the strides the step dispatched (a
    CUDA-graph replay, ``roofline_resblock.graph_ms``: a call's device time
    with no host gaps) and takes the device time of its convolution
    kernels apart from the rest of the call (cuDNN's layout conversions,
    the bias add) by ``torch.profiler`` and ``profile_decode``'s classes;
  * times each spec's implicit-GEMM ceiling, one ``torch.matmul`` of the
    same M, N, K (K by the true-MAC taps);
  * measures the stream bandwidth by a triad over 1.5 GiB;
  * profiles the step (``trace_attrib``'s module ranges) and splits its
    device time into convolution and other kernels, per site too;
  * measures the step (``train/profiler.measure_steps``).

Then ``attainable_step_ms = conv_standalone_ms + nonconv_bytes / stream
bandwidth``, where ``conv_standalone_ms`` sums the specs' convolution
kernels (the conversions count as non-conv, as in the step's profile), and
``headroom_pct = 100 * (measured_step_ms / attainable_step_ms - 1)``. The
report goes to ``--out`` (default under ``reports/torch_r13/``) with the
card's name and power limit; no number in it is taken on another device.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import tempfile
from collections import defaultdict
from types import SimpleNamespace

import numpy as np
import torch
import torch.utils._python_dispatch

from ..configs.options import MaskToImageTrainOptions
from ..data.synthetic import synthetic_batch
from ..kernels import bounds
from ..kernels import calls as kcalls
from ..models.factory import create_model, resolve_device
from ..train.profiler import measure_steps
from ..train.state import make_optimizers
from ..train.steps import make_train_step
from . import profile_decode
from .ab_kernels import card_line
from .roofline_resblock import cuda_ms, graph_ms

REPORTS = os.path.join("reports", "torch_r13")
SPECS = os.path.join(tempfile.gettempdir(), "himan_conv_specs.json")
TRACE_DIR = os.path.join(tempfile.gettempdir(), "himan_prof")
# BASELINE.json config 3, and the widths the CPU tests run it at
FLAGSHIP = dict(label_nc=35, ngf=64, ndf=64, n_downsample_global=4, n_blocks_global=9,
                num_D=2, n_layers_D=3, use_masked_image=True)
SMOKE = dict(label_nc=8, ngf=8, ndf=8, n_downsample_global=2, n_blocks_global=1,
             num_D=1, n_layers_D=2, use_masked_image=True)
HW, SMOKE_HW = (256, 512), (64, 128)
GRAPH_BELOW_MS = 0.02        # a spec faster than this is timed by graph replay
STREAM_ELEMS = 2**27         # three fp32 buffers of 512 MiB: the triad moves 1.5 GiB
STREAM_ELEMS_CPU = 2**20
aten = torch.ops.aten


# ---------------------------------------------------------------- the config

def add_config_args(p, bs=32):
    """The flagship's flags shared by the measurement tools."""
    p.add_argument("--bs", type=int, default=bs)
    p.add_argument("--dtype", default="bfloat16", choices=("bfloat16", "float32"))
    p.add_argument("--smoke", action="store_true",
                   help="tiny widths and 64x128 (the CPU tests')")
    p.add_argument("--gpu_ids", default="0", help="-1 for the CPU")


def device_of(gpu_ids) -> torch.device:
    """The device ``--gpu_ids`` names; raises when it asks for a card and
    there is none (``models/factory.resolve_device``)."""
    return resolve_device(SimpleNamespace(gpu_ids=gpu_ids))


def device_line(device) -> str:
    """The card's name and power limit as nvidia-smi gives them, or cpu."""
    return card_line() if device.type == "cuda" else "cpu"


def flagship(args, **overrides):
    """(opt, model, batch, compute_dtype) of the flagship step at the
    arguments' batch, dtype and widths (``overrides``: option changes)."""
    arch = dict(SMOKE if args.smoke else FLAGSHIP, **overrides)
    opt = MaskToImageTrainOptions(gpu_ids=args.gpu_ids, batchSize=args.bs, dtype=args.dtype,
                                  **arch)
    model = create_model(opt)
    batch = synthetic_batch(np.random.RandomState(0), args.bs,
                            hw=SMOKE_HW if args.smoke else HW, label_nc=opt.label_nc)
    batch = {k: torch.from_numpy(v).to(model.device) for k, v in batch.items()}
    return opt, model, batch, torch.bfloat16 if args.dtype == "bfloat16" else None


def make_step(opt, model, compute_dtype):
    """(step, state): ``make_train_step`` and a fresh Adam pair."""
    return make_train_step(model, compute_dtype), make_optimizers(opt, model, 1000)


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timed_ms(fn, device, iters, graph=False):
    """ms a call of fn: CUDA events over warmed-up calls on the card, by a
    CUDA-graph replay when a call is under GRAPH_BELOW_MS or ``graph`` (no
    host gaps between launches); the host clock after a sync elsewhere
    (``measure_steps``)."""
    if device.type == "cuda":
        if graph:
            return graph_ms(fn, iters)
        ms = cuda_ms(fn, iters)
        return graph_ms(fn, iters) if ms < GRAPH_BELOW_MS else ms
    return 1e3 * measure_steps(lambda s, b: fn(), None, None, iters, device)


# ------------------------------------------------- true-MAC FLOPs (JAX form)

def _dilate(size, d):
    return 0 if size == 0 else (size - 1) * d + 1


def _conv_flops(rec):
    """TRUE-MAC flop count of a convolution in the JAX tool's record form
    (JAX ``tools/roofline_step.py:130``): kernel taps that land on
    lhs-dilation zeros do no arithmetic and are not counted; tap j of
    output y is real iff (y*stride - pad_lo + j*rhs_dil) % lhs_dil == 0.
    Padding taps count as work; equal to the naive count when lhs_dilation
    is 1."""
    lhs, rhs = rec["lhs_shape"], rec["rhs_shape"]
    dn = rec["dimension_numbers"]
    ln, lc = dn[0][0], dn[0][1]
    lspatial = dn[0][2:]
    rk_out = dn[1][0]
    rspatial = dn[1][2:]
    n = lhs[ln]
    cin = lhs[lc]
    cout = rhs[rk_out]
    tap_prod = 1.0
    for i, d in enumerate(lspatial):
        ld = rec["lhs_dilation"][i]
        rd = rec["rhs_dilation"][i]
        k = rhs[rspatial[i]]
        size = (lhs[d] - 1) * ld + 1
        ksize = (k - 1) * rd + 1
        pad = rec["padding"][i]
        stride = rec["window_strides"][i]
        o = (size + pad[0] + pad[1] - ksize) // stride + 1
        if ld == 1:
            tap_sum = o * k
        else:
            full, rem = divmod(o, ld)
            per_phase = [
                sum(1 for j in range(k) if ((y * stride - pad[0]) + j * rd) % ld == 0)
                for y in range(ld)
            ]
            tap_sum = full * sum(per_phase) + sum(per_phase[:rem])
        tap_prod *= tap_sum
    return 2.0 * n * cout * cin * tap_prod / rec["feature_group_count"]


def _out_spatial(rec):
    dn = rec["dimension_numbers"]
    out = []
    for i, d in enumerate(dn[0][2:]):
        size = _dilate(rec["lhs_shape"][d], rec["lhs_dilation"][i])
        ksize = _dilate(rec["rhs_shape"][dn[1][2 + i]], rec["rhs_dilation"][i])
        lo, hi = rec["padding"][i]
        out.append((size + lo + hi - ksize) // rec["window_strides"][i] + 1)
    return out


def jax_form(x_shape, w_shape, stride, padding, dilation, transposed, output_padding,
             groups):
    """The JAX ``conv_general_dilated`` record of a torch convolution (NCHW
    input, OIHW weight; a transposed one, IOHW, as the lhs-dilated
    convolution it is)."""
    rec = dict(lhs_shape=list(x_shape), rhs_shape=list(w_shape), rhs_dilation=list(dilation),
               feature_group_count=int(groups))
    if not transposed:
        return dict(rec, dimension_numbers=[[0, 1, 2, 3], [0, 1, 2, 3], [0, 1, 2, 3]],
                    window_strides=list(stride), padding=[[p, p] for p in padding],
                    lhs_dilation=[1] * len(stride))
    k = w_shape[2:]
    pads = [[d * (kk - 1) - p, d * (kk - 1) - p + op]
            for kk, p, d, op in zip(k, padding, dilation, output_padding)]
    return dict(rec, dimension_numbers=[[0, 1, 2, 3], [1, 0, 2, 3], [0, 1, 2, 3]],
                window_strides=[1] * len(stride), padding=pads, lhs_dilation=list(stride))


def _swap01(spec):
    return [spec[1], spec[0], *spec[2:]]


def _grad_shape(rec):
    """The forward output's shape in the record's out_spec order."""
    dn = rec["dimension_numbers"]
    shape = [0] * len(rec["lhs_shape"])
    shape[dn[2][0]] = rec["lhs_shape"][dn[0][0]]
    shape[dn[2][1]] = rec["rhs_shape"][dn[1][0]]
    for i, o in enumerate(_out_spatial(rec)):
        shape[dn[2][2 + i]] = o
    return shape


def dgrad_rec(rec):
    """JAX's transpose rule for the lhs (``_conv_general_dilated_transpose_lhs``,
    ``_conv_general_vjp_lhs_padding``) on a forward record."""
    dn = rec["dimension_numbers"]
    g = _grad_shape(rec)
    pads = []
    for i, d in enumerate(dn[0][2:]):
        in_d = _dilate(rec["lhs_shape"][d], rec["lhs_dilation"][i])
        k_d = _dilate(rec["rhs_shape"][dn[1][2 + i]], rec["rhs_dilation"][i])
        out_d = _dilate(g[dn[2][2 + i]], rec["window_strides"][i])
        before = k_d - rec["padding"][i][0] - 1
        pads.append([before, in_d + k_d - 1 - out_d - before])
    return dict(lhs_shape=g, rhs_shape=list(rec["rhs_shape"]),
                dimension_numbers=[list(dn[2]), _swap01(dn[1]), list(dn[0])],
                window_strides=list(rec["lhs_dilation"]), padding=pads,
                lhs_dilation=list(rec["window_strides"]), rhs_dilation=list(rec["rhs_dilation"]),
                feature_group_count=rec["feature_group_count"])


def wgrad_rec(rec):
    """JAX's transpose rule for the rhs (``_conv_general_dilated_transpose_rhs``,
    ``_conv_general_vjp_rhs_padding``) on a forward record."""
    dn = rec["dimension_numbers"]
    g = _grad_shape(rec)
    pads = []
    for i, d in enumerate(dn[0][2:]):
        in_d = _dilate(rec["lhs_shape"][d], rec["lhs_dilation"][i])
        k_d = _dilate(rec["rhs_shape"][dn[1][2 + i]], rec["rhs_dilation"][i])
        out_d = _dilate(g[dn[2][2 + i]], rec["window_strides"][i])
        lo = rec["padding"][i][0]
        pads.append([lo, out_d - in_d + k_d - lo - 1])
    return dict(lhs_shape=list(rec["lhs_shape"]), rhs_shape=g,
                dimension_numbers=[_swap01(dn[0]), _swap01(dn[2]), _swap01(dn[1])],
                window_strides=list(rec["rhs_dilation"]), padding=pads,
                lhs_dilation=list(rec["lhs_dilation"]), rhs_dilation=list(rec["window_strides"]),
                feature_group_count=1)


def gemm_dims(rec):
    """(M, K, N) of a record's implicit GEMM (the JAX tool's ceiling shape:
    M = N * output pixels, K = the true-MAC average taps x Cin, N = Cout)."""
    lhs, rhs = rec["lhs_shape"], rec["rhs_shape"]
    dn = rec["dimension_numbers"]
    cin = lhs[dn[0][1]] // rec["feature_group_count"]
    out = _out_spatial(rec)
    m = lhs[dn[0][0]] * int(np.prod(out))
    taps = 1.0
    for i, o in enumerate(out):
        ld, rd, k = rec["lhs_dilation"][i], rec["rhs_dilation"][i], rhs[dn[1][2 + i]]
        if ld == 1:
            taps *= k
        else:
            pad, stride = rec["padding"][i], rec["window_strides"][i]
            per_phase = [sum(1 for j in range(k) if ((y * stride - pad[0]) + j * rd) % ld == 0)
                         for y in range(ld)]
            full, rem = divmod(o, ld)
            taps *= (full * sum(per_phase) + sum(per_phase[:rem])) / o
    return m, max(int(round(taps * cin)), 1), rhs[dn[1][0]]


# ------------------------------------------------------------ the collector

def layout(t) -> str:
    if t.dim() == 4 and not t.is_contiguous() and t.is_contiguous(
            memory_format=torch.channels_last):
        return "channels_last"
    return "contiguous" if t.is_contiguous() else "strided"


def _tensors(x):
    if torch.is_tensor(x):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)


def _moves_bytes(func) -> bool:
    """False for ops that only alias their inputs (views) or only
    allocate (``empty``)."""
    name = func._schema.name
    if name.startswith(("aten::empty", "aten::_local_scalar_dense")):
        return False
    rets = func._schema.returns
    return not (rets and all(r.alias_info is not None and not r.alias_info.is_write
                             for r in rets))


def module_paths(model):
    """{module: 'G.res3.conv1'}: every submodule of the model's networks by
    its path under the network's JAX name (``Pix2PixHDModel.nets``)."""
    return {sub: f"{net}.{name}" if name else net
            for net, m in model.nets().items() for name, sub in m.named_modules()}


@contextlib.contextmanager
def module_hooks(model, enter, leave):
    """enter(path) before and leave(path) after every submodule's forward
    (their results are dropped: a hook's result would replace the module's
    input or output)."""
    def pre(path):
        def hook(m, a):
            enter(path)
        return hook

    def post(path):
        def hook(m, a, o):
            leave(path)
        return hook

    handles = []
    for mod, path in module_paths(model).items():
        handles.append(mod.register_forward_pre_hook(pre(path)))
        handles.append(mod.register_forward_hook(post(path)))
    try:
        yield
    finally:
        for h in handles:
            h.remove()


class StepCollector(torch.utils._python_dispatch.TorchDispatchMode):
    """Records what the step dispatches inside it: the convolution specs
    with their multiplicity, the bytes of every other aten op, and (through
    ``port_call``) the port kernels' bytes; per module site too."""

    def __init__(self):
        super().__init__()
        self.convs = {}
        self.sites = defaultdict(lambda: {"flops": 0.0, "bytes": 0})
        self.op_bytes = defaultdict(int)
        self.port_bytes = defaultdict(int)
        self.port_calls = defaultdict(int)
        self.stack = []
        self.weight_site = {}
        self.depth = 0

    def site(self):
        return self.stack[-1] if self.stack else "(top)"

    def port_call(self, kind, orig, *a, **k):
        """``kernels/calls.intercept``'s callback: counts a port kernel
        call's bytes (``bounds.call_bytes``), then calls the wrapper with
        the dispatch mode's counting off."""
        if self.depth == 0:
            nbytes = bounds.call_bytes(kind, *a, **k)
            self.port_bytes[kind] += nbytes
            self.port_calls[kind] += 1
            self.sites[self.site()]["bytes"] += nbytes
        self.depth += 1
        try:
            return orig(*a, **k)
        finally:
            self.depth -= 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self.depth:
            return out
        if func is aten.convolution.default:
            self._fwd(*args)
        elif func is aten.convolution_backward.default:
            self._bwd(*args)
        elif _moves_bytes(func):
            seen = {}
            for t in (*_tensors(list(args)), *_tensors(list(kwargs.values())), *_tensors(out)):
                seen[(t.data_ptr(), tuple(t.shape), tuple(t.stride()), t.dtype)] = (
                    t.numel() * t.element_size())
            nbytes = sum(seen.values())
            self.op_bytes[func._schema.name] += nbytes
            self.sites[self.site() if self.stack else "(top or backward)"]["bytes"] += nbytes
        return out

    @staticmethod
    def _wkey(w):
        return (w.untyped_storage().data_ptr(), w.storage_offset(), tuple(w.shape))

    def _add(self, kind, site, rec, tensors, extra):
        spec = dict(kind=kind, dtype=str(tensors["input"].dtype).replace("torch.", ""),
                    **{f"{k}_shape": list(t.shape) for k, t in tensors.items()},
                    **{f"{k}_stride": list(t.stride()) for k, t in tensors.items()},
                    **{f"{k}_layout": layout(t) for k, t in tensors.items()}, **extra)
        key = json.dumps(spec, sort_keys=True)
        row = self.convs.get(key)
        if row is None:
            row = self.convs[key] = dict(spec, rec=rec, flops=_conv_flops(rec), count=0,
                                         sites=[])
        row["count"] += 1
        if site not in row["sites"]:
            row["sites"].append(site)
        self.sites[f"{site} [{kind}]"]["flops"] += row["flops"]

    def _fwd(self, x, w, b, stride, padding, dilation, transposed, output_padding, groups):
        site = self.site()
        self.weight_site[self._wkey(w)] = site
        extra = dict(bias=b is not None, stride=list(stride), padding=list(padding),
                     dilation=list(dilation), transposed=bool(transposed),
                     output_padding=list(output_padding), groups=int(groups))
        rec = jax_form(x.shape, w.shape, stride, padding, dilation, transposed, output_padding,
                       groups)
        self._add("fwd", site, rec, {"input": x, "weight": w}, extra)

    def _bwd(self, go, x, w, bias_sizes, stride, padding, dilation, transposed, output_padding,
             groups, mask):
        site = self.weight_site.get(self._wkey(w), "(backward)")
        extra = dict(bias=False, stride=list(stride), padding=list(padding),
                     dilation=list(dilation), transposed=bool(transposed),
                     output_padding=list(output_padding), groups=int(groups))
        rec = jax_form(x.shape, w.shape, stride, padding, dilation, transposed, output_padding,
                       groups)
        tensors = {"input": x, "weight": w, "grad_output": go}
        if mask[0]:
            self._add("dgrad", site, dgrad_rec(rec), tensors, extra)
        if mask[1]:
            self._add("wgrad", site, wgrad_rec(rec), tensors, extra)


def collect(opt, model, batch, compute_dtype):
    """One step after a warm-up step, under the collector -> the specs
    document (``--specs``)."""
    step, state = make_step(opt, model, compute_dtype)
    step(state, batch)
    sync(model.device)
    coll = StepCollector()

    def enter(p):
        coll.stack.append(p)

    def leave(p):
        coll.stack.pop()

    with module_hooks(model, enter, leave), kcalls.intercept(coll.port_call), coll:
        step(state, batch)
    sync(model.device)
    convs = sorted(coll.convs.values(), key=lambda r: -r["flops"] * r["count"])
    totals = defaultdict(float)
    for r in convs:
        totals[r["kind"]] += r["flops"] * r["count"]
    nonconv = sum(coll.op_bytes.values()) + sum(coll.port_bytes.values())
    return {
        "config": {k: getattr(opt, k) for k in (*FLAGSHIP, "batchSize", "dtype")},
        "hw": list(batch["label"].shape[1:]),
        "device": str(model.device),
        "n_specs": len(convs),
        "n_conv_ops": sum(r["count"] for r in convs),
        "conv_flops": dict(totals),
        "conv_total_tflop": sum(totals.values()) / 1e12,
        "nonconv_bytes": nonconv,
        "aten_bytes": sum(coll.op_bytes.values()),
        "port_kernel_bytes": dict(coll.port_bytes),
        "port_kernel_calls": dict(coll.port_calls),
        "op_bytes": dict(sorted(coll.op_bytes.items(), key=lambda kv: -kv[1])),
        "sites": {k: dict(v) for k, v in coll.sites.items()},
        "convs": convs,
    }


# ------------------------------------------------------------------ bench

def _filled(shape, stride, dtype, device, gen):
    """N(0, 1) values drawn on ``device`` into a tensor of these strides."""
    return torch.empty_strided(shape, stride, dtype=dtype, device=device).normal_(generator=gen)


def spec_call(spec, device, gen):
    """A no-argument function running the spec alone on tensors of its
    shapes and strides."""
    dt = getattr(torch, spec["dtype"])

    def make(k):
        return _filled(spec[f"{k}_shape"], spec[f"{k}_stride"], dt, device, gen)

    x, w = make("input"), make("weight")
    args = (spec["stride"], spec["padding"], spec["dilation"], spec["transposed"],
            spec["output_padding"], spec["groups"])
    if spec["kind"] == "fwd":
        cout = w.shape[1] * spec["groups"] if spec["transposed"] else w.shape[0]
        b = torch.zeros(cout, dtype=dt, device=device) if spec["bias"] else None
        return lambda: aten.convolution(x, w, b, *args)
    go = make("grad_output")
    mask = [spec["kind"] == "dgrad", spec["kind"] == "wgrad", False]
    return lambda: aten.convolution_backward(go, x, w, None, *args, mask)


def kernel_split(fn, device, calls=3):
    """(device ms a call in convolution kernels, in all kernels, the
    kernels' names) of fn, from ``calls`` profiled calls after one
    (the CPU: no device kernels, (None, None, []))."""
    if device.type != "cuda":
        return None, None, []
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):   # a profile that caught no kernel is taken once more
        fn()
        sync(device)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            sync(device)
        ks = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        if ks:
            break
    conv = [e for e in ks if profile_decode.is_conv(profile_decode.kernel_kind(e.name))]
    return (sum(e.device_time for e in conv) / 1e3 / calls,
            sum(e.device_time for e in ks) / 1e3 / calls, sorted({e.name[:120] for e in ks}))


def gemm_ceiling_tflops(rec, dtype, device, cache, gen):
    m, k, n = gemm_dims(rec)
    bpe = torch.empty((), dtype=dtype).element_size()
    m = int(min(m, max(8192, (512 * 1024 * 1024) // max(k * bpe, 1))))
    key = (m, k, n, dtype)
    if key not in cache:
        a = torch.empty((m, k), dtype=dtype, device=device).normal_(generator=gen)
        b = torch.empty((k, n), dtype=dtype, device=device).normal_(generator=gen)
        ms = timed_ms(lambda: torch.matmul(a, b), device, 10)
        cache[key] = 2.0 * m * k * n / (ms * 1e-3) / 1e12
    return cache[key]


def stream_gbs(device):
    """GB/s of z = 0.5 x + y over three fp32 buffers (1.5 GiB on the card)."""
    n = STREAM_ELEMS if device.type == "cuda" else STREAM_ELEMS_CPU
    x, y = torch.rand(n, device=device), torch.rand(n, device=device)
    z = torch.empty_like(x)
    ms = timed_ms(lambda: torch.add(y, x, alpha=0.5, out=z), device, 20)
    return 3 * n * 4 / (ms * 1e-3) / 1e9


def bench(doc, opt, model, batch, compute_dtype, trace_dir, iters=10, profile_steps=2):
    """The report of ``--bench`` from a ``collect`` document."""
    from . import trace_attrib

    device = model.device
    gen = torch.Generator(device).manual_seed(0)
    rows, cache = [], {}
    conv_call_ms = conv_ms = total_flops = 0.0
    for spec in doc["convs"]:
        fn = spec_call(spec, device, gen)
        ms = timed_ms(fn, device, iters, graph=True)
        kms, dev_ms, names = kernel_split(fn, device)
        if kms is None:   # the CPU: the call is the convolution
            kms = dev_ms = ms
        ceil = gemm_ceiling_tflops(spec["rec"], getattr(torch, spec["dtype"]), device, cache, gen)
        tf = spec["flops"] / (kms * 1e-3) / 1e12 if kms else None
        conv_call_ms += ms * spec["count"]
        conv_ms += kms * spec["count"]
        total_flops += spec["flops"] * spec["count"]
        rows.append({
            "kind": spec["kind"], "lhs": spec["input_shape"], "rhs": spec["weight_shape"],
            "grad_output": spec.get("grad_output_shape"), "strides": spec["stride"],
            "padding": spec["padding"], "transposed": spec["transposed"],
            "lhs_dil": spec["rec"]["lhs_dilation"], "dtype": spec["dtype"],
            "layouts": [spec["input_layout"], spec["weight_layout"]],
            "count": spec["count"], "sites": spec["sites"], "ms": ms, "device_ms": dev_ms,
            "conv_kernel_ms": kms,
            "tflops": tf, "gemm_ceiling_tflops": ceil,
            "pct_of_ceiling": 100 * tf / ceil if tf and ceil else None, "kernels": names,
        })
        del fn
    bw = stream_gbs(device)
    step, state = make_step(opt, model, compute_dtype)
    measured = 1e3 * measure_steps(step, state, batch, iters, device)
    peak = torch.cuda.max_memory_allocated(device) / 1e9 if device.type == "cuda" else None
    attrib = trace_attrib.profile_step(model, step, state, batch, trace_dir, profile_steps,
                                       flops_by_site={k: v["flops"]
                                                      for k, v in doc["sites"].items()},
                                       bytes_by_site={k: v["bytes"]
                                                      for k, v in doc["sites"].items()})
    conv_graph = sum(ms for k, ms in attrib["by_class_ms"].items() if profile_decode.is_conv(k))
    nonconv_graph = attrib["device_ms_per_step"] - conv_graph
    nonconv_bound = doc["nonconv_bytes"] / (bw * 1e9) * 1e3
    attainable = conv_ms + nonconv_bound
    return {
        "device": device_line(device),
        "config": doc["config"], "hw": doc["hw"],
        "switches": {"cudnn.allow_tf32": torch.backends.cudnn.allow_tf32,
                     "cuda.matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32,
                     "cudnn.benchmark": torch.backends.cudnn.benchmark},
        "measured_step_ms": measured,
        "peak_memory_gb": peak,
        "device_ms_per_step": attrib["device_ms_per_step"],
        "idle_share": max(0.0, 1 - attrib["device_ms_per_step"] / measured),
        "conv_in_graph_ms": conv_graph,
        "layout_conversion_in_graph_ms": attrib["by_class_ms"].get("layout conversion (cuDNN)",
                                                                   0.0),
        "conv_standalone_ms": conv_ms,
        "conv_standalone_call_ms": conv_call_ms,
        "conv_fusion_tax_ms": conv_graph - conv_ms,
        "conv_total_tflop": total_flops / 1e12,
        "conv_standalone_tflops": total_flops / (conv_ms * 1e-3) / 1e12 if conv_ms else None,
        "nonconv_in_graph_ms": nonconv_graph,
        "nonconv_bytes_gb": doc["nonconv_bytes"] / 1e9,
        "port_kernel_bytes_gb": sum(doc["port_kernel_bytes"].values()) / 1e9,
        "stream_bw_gbs_measured": bw,
        "nonconv_bound_ms": nonconv_bound,
        "attainable_step_ms": attainable,
        "headroom_pct": 100 * (measured / attainable - 1),
        "flop_ledger_note": (
            "conv FLOPs are true MACs of each spec's JAX form (lhs-dilation zeros "
            "excluded; padding taps counted); conv_standalone_ms sums only the "
            "convolution kernels of each standalone call, its cuDNN layout "
            "conversions (conv_standalone_call_ms less it) count as non-conv, as in "
            "the step's profile; nonconv bytes: every distinct tensor an aten op "
            "reads or writes, once, plus the port kernels' reckoned bytes"),
        "unclassified_pct": attrib["unclassified_pct"],
        "convs": sorted(rows, key=lambda r: -r["ms"] * r["count"])[:40],
        "convs_by_tflops": sorted(rows, key=lambda r: r["tflops"] or 0.0),
        "conv_sites_in_graph": [r for r in attrib["rows"]
                                if profile_decode.is_conv(r["class"])][:30],
    }


def write_json(path, obj):
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--collect", action="store_true")
    p.add_argument("--bench", action="store_true")
    p.add_argument("--specs", default=SPECS)
    p.add_argument("--trace_dir", default=TRACE_DIR)
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--out", default=os.path.join(REPORTS, "roofline_step.json"))
    add_config_args(p)
    args = p.parse_args(argv)
    device_of(args.gpu_ids)
    opt, model, batch, cdt = flagship(args)
    report = None
    if args.collect:
        doc = collect(opt, model, batch, cdt)
        write_json(args.specs, doc)
        print(f"wrote {args.specs}: {doc['n_specs']} distinct specs, {doc['n_conv_ops']} conv "
              f"ops, {doc['conv_total_tflop']:.3f} TFLOP, non-conv "
              f"{doc['nonconv_bytes'] / 1e9:.3f} GB", flush=True)
    if args.bench:
        with open(args.specs) as f:
            doc = json.load(f)
        report = bench(doc, opt, model, batch, cdt, args.trace_dir, args.iters)
        write_json(args.out, report)
        print(json.dumps({k: v for k, v in report.items()
                          if k not in ("convs", "convs_by_tflops", "conv_sites_in_graph")},
                         indent=1), flush=True)
    return report


if __name__ == "__main__":
    main()
