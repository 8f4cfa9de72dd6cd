"""The work of a step or a forward, counted from a configuration's published
layer lists: the same count whatever kernels do the work.

FLOPs are true multiply-adds x 2. A convolution's forward, its data
gradient and its weight gradient each count once the forward's MACs; taps
on zero padding count, taps on a transposed convolution's dilation zeros do
not (a 3x3 stride-2 transposed convolution of an m-long axis has 3m - 1 real
taps on it). A train step counts the forward and the backward it needs and
no recomputation: weight gradients of the trained networks, data gradients
wherever an input needs one (not into a network's first layer from the data
or the conditioning). VGG19 is frozen: a forward on the fake and on the
real image, a data gradient on the fake. D's loss and G's see D three
times a sample: on the fake for G (data gradients only) and on the real and
the held fake for D (weight gradients, and data gradients below the first
layer).

A model's own layers come from its module, the one that declares its name
(``reference/registry.py``): G's layers and IN sites, D's input and scales,
VGG's taps and the linear layers. The arithmetic they share is here.

IN bytes: every instance-norm site's forward reads x (and the residual,
where one is added) and writes y; its backward reads x and dy and writes
dx; each writes or reads its per-(sample, channel) mean and rstd in fp32.

What the port dispatches differs from this count in one place, which
``port_differences`` gives: its discriminators split the first
convolution's input into the conditioning and the image and, where one
apply stacks real and fake, run the conditioning's share once for both.
The port's own collector of dispatched convolutions
(``tools/roofline_step.py --collect``) counts two things otherwise, by
convention and not by work: a data gradient in the form JAX writes it, a
convolution over the output gradient whose taps on that gradient's zero
padding count (this count takes a data gradient's true MACs, the
forward's); and a transposed convolution's tap past each axis's last input,
which lands on the output padding (3m taps on an m-long axis, not 3m - 1).
``port_bench/tests/test_bench_flops.py`` holds this count to the collector's
apart from these three.
"""

from __future__ import annotations

from .reference import registry


def conv(n, ho, wo, cin, cout, k):
    return 2.0 * n * ho * wo * cin * cout * k * k


def convt(n, hi, wi, cin, cout):
    return 2.0 * n * (3 * hi - 1) * (3 * wi - 1) * cin * cout


def _patch_d(h, w, cin, ndf, n_layers):
    """[(fwd FLOPs a sample, cin)] of a PatchGAN's layers on h x w, and the
    IN sites' (elements a sample, channels)."""
    layers, sites = [], []
    h, w = h // 2 + 1, w // 2 + 1
    layers.append((conv(1, h, w, cin, ndf, 4), cin))
    nf = ndf
    for _ in range(1, n_layers):
        prev, nf = nf, min(nf * 2, 512)
        h, w = h // 2 + 1, w // 2 + 1
        layers.append((conv(1, h, w, prev, nf, 4), prev))
        sites.append((h * w * nf, nf))
    prev, nf = nf, min(nf * 2, 512)
    h, w = h + 1, w + 1
    layers.append((conv(1, h, w, prev, nf, 4), prev))
    sites.append((h * w * nf, nf))
    h, w = h + 1, w + 1
    layers.append((conv(1, h, w, nf, 1, 4), nf))
    return layers, sites


def _d_scales(cfg, h, w, cin, num_d):
    out = []
    for _ in range(num_d):
        out.append(_patch_d(h, w, cin, cfg["ndf"], cfg["n_layers_D"]))
        h, w = (h + 1) // 2, (w + 1) // 2
    return out


def _d_work(scales, n, first_grad_share):
    """(fwd, wgrad, dgrad) FLOPs of D's three applies a sample times n: on
    the fake for G (forward; data gradients, the first layer's for the
    image's share of its input), on real and held fake (forward; weight
    gradients; data gradients below the first layer)."""
    fwd = wgrad = dgrad = 0.0
    for layers, _ in scales:
        f = sum(x for x, _ in layers)
        below = sum(x for x, _ in layers[1:])
        fwd += 3 * n * f
        wgrad += 2 * n * f
        dgrad += n * (below + layers[0][0] * first_grad_share) + 2 * n * below
    return fwd, wgrad, dgrad


def _in_bytes(sites, elem):
    """(forward, backward) bytes of IN sites [(elements, channels, has residual, rows)]."""
    fwd = sum(rows * (e * elem * (3 if res else 2) + c * 8) for e, c, res, rows in sites)
    bwd = sum(rows * (3 * e * elem + c * 8) for e, c, res, rows in sites)
    return fwd, bwd


def _global_g(cfg, h, w):
    """[(fwd FLOPs a sample, needs a data gradient)] and IN sites [(elements,
    channels, residual)] of the GlobalGenerator on h x w."""
    nc, ngf, nd, nb = cfg["label_nc"], cfg["ngf"], cfg["n_downsample_global"], cfg["n_blocks_global"]
    cin = nc + 1 + 3
    layers = [(conv(1, h, w, cin, ngf, 7), False)]
    sites = [(h * w * ngf, ngf, False)]
    c, hh, ww = ngf, h, w
    for _ in range(nd):
        hh, ww = hh // 2, ww // 2
        layers.append((conv(1, hh, ww, c, 2 * c, 3), True))
        c *= 2
        sites.append((hh * ww * c, c, False))
    for _ in range(nb):
        layers += [(conv(1, hh, ww, c, c, 3), True)] * 2
        sites += [(hh * ww * c, c, False), (hh * ww * c, c, True)]
    for _ in range(nd):
        layers.append((convt(1, hh, ww, c, c // 2), True))
        hh, ww, c = hh * 2, ww * 2, c // 2
        sites.append((hh * ww * c, c, False))
    layers.append((conv(1, h, w, ngf, 3, 7), True))
    return layers, sites


VGG_CFG = ((64, 64), (128, 128), (256,) * 4, (512,) * 4, (512,) * 4)


def _vgg_taps(h, w):
    """Fwd FLOPs a sample of VGG19 up to relu5_1 (13 convolutions)."""
    total, cin = 0.0, 3
    for b, widths in enumerate(VGG_CFG):
        if b:
            h, w = h // 2, w // 2
        for c in range(1 if b == len(VGG_CFG) - 1 else len(widths)):
            total += conv(1, h, w, cin, widths[c], 3)
            cin = widths[c]
    return total


def train_step(cfg, n, hw, elem_bytes, model=None):
    """{"conv", "conv_fwd", "conv_wgrad", "conv_dgrad", "linear": FLOPs;
    "in_fwd_bytes", "in_bwd_bytes"} of one train step on n samples of hw.
    ``model``: the model's module (``reference/registry.py``), by default
    the one that declares ``cfg["model"]``."""
    h, w = hw
    m = model or registry.find(cfg["model"])
    g_layers, g_sites = m.g_layers(cfg, h, w)
    cin, cond, num_d = m.d_input(cfg)
    scales = _d_scales(cfg, h, w, cin, num_d)
    vgg = m.vgg_taps(cfg, h, w)
    g_fwd = n * sum(f for f, _ in g_layers)
    g_dgrad = n * sum(f for f, dgrad in g_layers if dgrad)
    # the first layer's data gradient reaches the image, not the conditioning
    d_fwd, d_wgrad, d_dgrad = _d_work(scales, n, (cin - cond) / cin)
    sites = [(e, c, r, n) for e, c, r in g_sites]
    for _, d_sites in scales:
        sites += [(e, c, False, 3 * n) for e, c in d_sites]
    in_fwd, in_bwd = _in_bytes(sites, elem_bytes)
    out = {"conv_fwd": g_fwd + d_fwd + 2 * n * vgg,      # VGG: fake and real
           "conv_wgrad": g_fwd + d_wgrad,                 # VGG is frozen
           "conv_dgrad": g_dgrad + d_dgrad + n * vgg,     # VGG: back to the fake
           "linear": m.linear(cfg, n), "in_fwd_bytes": in_fwd, "in_bwd_bytes": in_bwd}
    out["conv"] = out["conv_fwd"] + out["conv_wgrad"] + out["conv_dgrad"]
    return out


def g_forward(cfg, n, hw, model=None):
    """FLOPs of the served forward (G) on n samples of hw."""
    layers, _ = (model or registry.find(cfg["model"])).g_layers(cfg, *hw)
    return n * sum(f for f, _ in layers)


def port_differences(cfg, n, hw, model=None):
    """FLOPs of ``train_step``'s count that the port does not dispatch: the
    conditioning's share of D's first convolution on the held fake of the
    stacked real-and-fake apply (the port computes it once and tiles it for
    both), its forward and its weight gradient: each is half this."""
    h, w = hw
    cin, cond, num_d = (model or registry.find(cfg["model"])).d_input(cfg)
    scales = _d_scales(cfg, h, w, cin, num_d)
    return sum(2 * n * layers[0][0] * cond / cin for layers, _ in scales)
