"""W-sharded generator inference — counterpart of ``parallel/spatial.py``
in the JAX package: every layer of the GlobalGenerator (and of the 1024p
LocalEnhancer) runs with its activations split along W over the ranks of
one mesh axis, for images whose activations outgrow one card.

Each rank holds a W slab. Before a conv it widens its slab with the
columns its neighbours hold (a halo), as the JAX package does:

  * a reflect-padded stride-1 conv takes k//2 columns from each side, and
    the edge shards fill the global border with their own reflected
    interior (``ReflectionPad2d`` over the whole image);
  * a stride-2 down and the 3x3/s2 average pool take one column from the
    left only, the transposed-conv up one from the right only (zeros at the
    global edge: the unsharded ops' zero padding);
  * InstanceNorm sums its statistics over the axis in fp32 (two
    ``all_reduce`` calls: the mean, then the squared deviations).

The halos travel by ``all_gather`` of each rank's edge columns (at most 3
wide), not by point-to-point sends: gloo sends CPU tensors only, but it
gathers CUDA tensors, so one code path runs over NCCL across cards, over
gloo on the CPU and over gloo with two ranks on one card. Activations are
NCHW inside (``F.conv2d``'s layout); the public functions take and return
the JAX package's NHWC slabs. Weights are read from the port's modules
(torch layouts); the dead biases under IN are skipped, as there.

Like the JAX path, this is plain framework code (convolutions by cuDNN,
the IN statistics and pools in PyTorch): it launches none of the port's
hand-written kernels.
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F

_EPS = 1e-5


def _exchange_lr(x, left: int, right: int, mesh, axis: str, reflect_edges: bool = False):
    """Widen an NCHW slab with ``left`` / ``right`` neighbour columns. The
    global edges take zeros or, with ``reflect_edges``, the edge shard's
    own columns mirrored (no edge repeat)."""
    n, idx = mesh.axis_size(axis), mesh.axis_index(axis)
    w = x.shape[3]
    parts = mesh.all_gather(torch.cat([x[..., w - left:], x[..., :right]], 3), axis)
    out = []
    if left:
        if idx > 0:
            out.append(parts[idx - 1][..., :left])
        elif reflect_edges:
            out.append(x[..., 1:left + 1].flip(3))
        else:
            out.append(torch.zeros_like(x[..., :left]))
    out.append(x)
    if right:
        if idx < n - 1:
            out.append(parts[idx + 1][..., left:])
        elif reflect_edges:
            out.append(x[..., w - right - 1:w - 1].flip(3))
        else:
            out.append(torch.zeros_like(x[..., :right]))
    return torch.cat(out, 3)


def _nchw(x):
    return x.permute(0, 3, 1, 2).contiguous()


def _nhwc(x):
    return x.permute(0, 2, 3, 1).contiguous()


def halo_exchange_conv2d(x, w, b=None, *, padding: int, mesh, axis: str = "data"):
    """A stride-1 zero-padded conv over W-sharded NHWC slabs (w in torch's
    (Cout, Cin, k, k), k = 2 * padding + 1): the slab widened by
    ``padding`` halo columns a side, then the conv VALID along W and padded
    along the unsharded H. Equals this rank's W slice of the unsharded
    conv."""
    if w.shape[3] != 2 * padding + 1:
        raise ValueError("halo conv expects symmetric odd kernels")
    widened = _exchange_lr(_nchw(x), padding, padding, mesh, axis)
    return _nhwc(F.conv2d(widened, w, b, padding=(padding, 0)))


def make_spatial_conv(mesh, w, b=None, *, padding: int, axis: str = "data"):
    """``halo_exchange_conv2d`` with its weights bound: x slab -> y slab."""
    return lambda x: halo_exchange_conv2d(x, w, b, padding=padding, mesh=mesh, axis=axis)


def _sconv_reflect(x, conv, mesh, axis):
    """A reflect-padded k x k stride-1 conv (``networks.Conv``, reflect k//2)."""
    p = conv.weight.shape[3] // 2
    xp = F.pad(x, (0, 0, p, p), mode="reflect")
    widened = _exchange_lr(xp, p, p, mesh, axis, reflect_edges=True)
    return F.conv2d(widened, conv.weight, None if conv.dead_bias else conv.bias)


def _sconv_down(x, conv, mesh, axis):
    """3x3 stride-2 pad-1 conv (even slab width): the first output column
    of shard d reads global column d * Ws - 1, so a left halo of 1."""
    widened = _exchange_lr(x, 1, 0, mesh, axis)
    return F.conv2d(widened, conv.weight, None if conv.dead_bias else conv.bias, stride=2,
                    padding=(1, 0))


def _sconv_up(x, up, mesh, axis):
    """ConvTranspose2d(k3, s2, p1, op1): local output column j reads input
    columns (j - 1) / 2 .. (j + 1) / 2, so a right halo of 1; the transposed
    conv over the widened slab, its last column cropped."""
    widened = _exchange_lr(x, 0, 1, mesh, axis)
    y = F.conv_transpose2d(widened, up.weight, None if up.dead_bias else up.bias, stride=2,
                           padding=1, output_padding=(1, 0))
    return y[..., :2 * x.shape[3]]


def _s_instance_norm(x, mesh, axis, eps=_EPS):
    """InstanceNorm2d(affine=False) whose mean and biased variance sum over
    the axis's slabs in fp32 (the JAX ``_s_instance_norm``)."""
    xf = x.to(torch.float32)
    cnt = float(x.shape[2] * x.shape[3] * mesh.axis_size(axis))
    s = xf.sum((2, 3), keepdim=True)
    torch.distributed.all_reduce(s, group=mesh.groups[axis])
    mean = s / cnt
    ss = (xf - mean).square().sum((2, 3), keepdim=True)
    torch.distributed.all_reduce(ss, group=mesh.groups[axis])
    return ((xf - mean) * torch.rsqrt(ss / cnt + eps)).to(x.dtype)


def _s_norm_relu(h, mesh, axis, eps):
    return torch.clamp_min(_s_instance_norm(h, mesh, axis, eps), 0)


def _s_resblocks(blocks, h, mesh, axis, eps):
    for r in blocks:
        y = _s_norm_relu(_sconv_reflect(h, r.conv1, mesh, axis), mesh, axis, eps)
        y = _sconv_reflect(y, r.conv2, mesh, axis)
        h = h + _s_instance_norm(y, mesh, axis, eps)
    return h


def _s_backbone(g, x, n_downsampling, n_blocks, mesh, axis, eps):
    """The GlobalGenerator trunk (stem .. ups, no head) over a W slab: the
    sharded GlobalGenerator and the LocalEnhancer's ``global`` subtree."""
    h = _s_norm_relu(_sconv_reflect(x, g.conv_in, mesh, axis), mesh, axis, eps)
    for i in range(n_downsampling):
        h = _s_norm_relu(_sconv_down(h, getattr(g, f"down{i}"), mesh, axis), mesh, axis, eps)
    h = _s_resblocks([getattr(g, f"res{i}") for i in range(n_blocks)], h, mesh, axis, eps)
    for i in range(n_downsampling):
        h = _s_norm_relu(_sconv_up(h, getattr(g, f"up{i}"), mesh, axis), mesh, axis, eps)
    return h


def _s_avg_pool_3x3s2(x, mesh, axis):
    """AvgPool2d(3, 2, 1, count_include_pad=False) over a W slab: a left
    halo as the stride-2 conv, and the inverse tap count global-border
    aware (the first column of shard 0 and the top row have 2 taps)."""
    widened = _exchange_lr(x, 1, 0, mesh, axis)
    h, ws = x.shape[2], x.shape[3]
    s_w = widened[..., 0:ws - 1:2] + widened[..., 1:ws:2] + widened[..., 2:ws + 1:2]
    hp = F.pad(s_w, (0, 0, 1, 1))
    s = hp[:, :, 0:h - 1:2] + hp[:, :, 1:h:2] + hp[:, :, 2:h + 1:2]
    h2, w2 = s.shape[2], s.shape[3]
    rows = torch.full((h2,), 3.0, device=x.device)
    rows[0] = 2.0
    cols = torch.full((w2,), 3.0, device=x.device)
    if mesh.axis_index(axis) == 0:
        cols[0] = 2.0
    inv = 1.0 / (rows[:, None] * cols[None, :])
    return (s.to(torch.float32) * inv).to(x.dtype)


def spatial_generator_forward(net, x, *, n_downsampling, n_blocks, mesh, axis: str = "data",
                              eps: float = _EPS):
    """The GlobalGenerator ``net`` (instance norm) over this rank's NHWC W
    slab -> its NHWC output slab."""
    h = _s_backbone(net, _nchw(x), n_downsampling, n_blocks, mesh, axis, eps)
    return _nhwc(torch.tanh(_sconv_reflect(h, net.conv_out, mesh, axis)))


def spatial_local_enhancer_forward(net, x, *, n_downsample_global, n_blocks_global,
                                   n_local_enhancers=1, n_blocks_local=3, mesh,
                                   axis: str = "data", eps: float = _EPS):
    """The LocalEnhancer ``net`` over a W slab: the sharded average-pool
    pyramid, the global trunk on the coarsest level, each local branch
    (stem, down, + the trunk, resblocks, up) and the head."""
    pyramid = [_nchw(x)]
    for _ in range(n_local_enhancers):
        pyramid.append(_s_avg_pool_3x3s2(pyramid[-1], mesh, axis))
    out = _s_backbone(getattr(net, "global"), pyramid[-1], n_downsample_global,
                      n_blocks_global, mesh, axis, eps)
    for n in range(1, n_local_enhancers + 1):
        def layer(name, n=n):
            return getattr(net, f"local{n}_{name}")

        h = _s_norm_relu(_sconv_reflect(pyramid[n_local_enhancers - n], layer("conv_in"), mesh,
                                        axis), mesh, axis, eps)
        h = _s_norm_relu(_sconv_down(h, layer("down"), mesh, axis), mesh, axis, eps)
        h = _s_resblocks([layer(f"res{i}") for i in range(n_blocks_local)], h + out, mesh,
                         axis, eps)
        out = _s_norm_relu(_sconv_up(h, layer("up"), mesh, axis), mesh, axis, eps)
    return _nhwc(torch.tanh(_sconv_reflect(out, net.conv_out, mesh, axis)))


def make_spatial_generator(mesh, net, *, n_downsampling, n_blocks, axis: str = "data"):
    """W-sharded GlobalGenerator inference: x slab -> output slab, under
    ``torch.no_grad``. The slab width must divide by 2**n_downsampling with
    a bottleneck of at least 2 columns (the resblocks' reflect-1 edge fill
    reads column 1) and be at least 4 (the stem's reflect-3 halo)."""

    @torch.no_grad()
    def fwd(x):
        ws = x.shape[2]
        if ws % (2 ** n_downsampling) or ws // (2 ** n_downsampling) < 2:
            raise ValueError(f"per-shard W {ws} incompatible with {n_downsampling} downs "
                             f"(bottleneck width must be >= 2)")
        if ws < 4:
            raise ValueError("stem reflect-3 halo needs per-shard W >= 4")
        return spatial_generator_forward(net, x, n_downsampling=n_downsampling,
                                         n_blocks=n_blocks, mesh=mesh, axis=axis)

    return fwd


def make_spatial_local_enhancer(mesh, net, *, n_downsample_global, n_blocks_global,
                                n_local_enhancers=1, n_blocks_local=3, axis: str = "data"):
    """W-sharded LocalEnhancer inference: the slab width must divide by
    2**(n_local_enhancers + n_downsample_global) with a bottleneck of at
    least 2 columns, and be at least 8."""
    need = 2 ** (n_local_enhancers + n_downsample_global)

    @torch.no_grad()
    def fwd(x):
        ws = x.shape[2]
        if ws % need or ws // need < 2 or ws < 8:
            raise ValueError(f"per-shard W {ws} incompatible (need multiple of {need}, "
                             f"bottleneck >= 2, ws >= 8)")
        return spatial_local_enhancer_forward(
            net, x, n_downsample_global=n_downsample_global, n_blocks_global=n_blocks_global,
            n_local_enhancers=n_local_enhancers, n_blocks_local=n_blocks_local, mesh=mesh,
            axis=axis)

    return fwd


def shard_w(x, mesh, axis: str = "data"):
    """This rank's W slab of a full NHWC tensor (W must divide evenly)."""
    n, i = mesh.axis_size(axis), mesh.axis_index(axis)
    ws = x.shape[2] // n
    if ws * n != x.shape[2]:
        raise ValueError(f"W {x.shape[2]} does not split over {n} shards")
    return x[:, :, i * ws:(i + 1) * ws]


def gather_w(y, mesh, axis: str = "data"):
    """The full NHWC tensor from every rank's W slab (each rank gets it)."""
    parts: List[torch.Tensor] = mesh.all_gather(y, axis)
    return torch.cat(parts, 2)
