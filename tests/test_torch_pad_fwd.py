"""The reflect pad's forward kernel on the CPU: its launch plan at the
networks' pad sites, its index arithmetic emulated byte for byte, and the
wrapper's CPU path, counters and byte reckoning.

``kernels/reflect_pad._fwd_plan`` picks the forward's form from the
pixel's byte width and x's alignment ("wide": whole 16-byte vectors a
pixel; "narrow": 16-byte chunks of the flat output) and cuts the output
rows into tiles. ``emulate_fwd`` repeats ``csrc/reflect_pad.cu``'s forward
item by item in numpy on the bytes of x: which output bytes each item
writes, which source bytes each reads, and, for the narrow form, which
aligned source vectors a chunk loads. The kernel itself runs only on the
card (``tests/test_torch_kernels_cuda.py``).
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from neurips18_hierchical_image_manipulation_tpu_torch.kernels import bounds
from neurips18_hierchical_image_manipulation_tpu_torch.kernels import calls as kcalls
from neurips18_hierchical_image_manipulation_tpu_torch.kernels import reflect_pad as krp
from neurips18_hierchical_image_manipulation_tpu_torch.ops import nnops

F32, BF16 = torch.float32, torch.bfloat16

# (N, H, W, C), pad, dtype, the form _fwd_plan picks: every pad site of the
# benchmark's cells (the flagship's resblocks and head at bs 32 bf16, bs 16
# and bs 1 fp32; the 1024p trunk's stem and resblocks, its branch's stem and
# resblocks, its head; box2mask's stem, resblocks and two heads)
SITES = [
    ((32, 32, 32, 1024), 1, BF16, "wide"), ((32, 512, 512, 64), 3, BF16, "wide"),
    ((16, 32, 32, 1024), 1, F32, "wide"), ((16, 512, 512, 64), 3, F32, "wide"),
    ((1, 32, 32, 1024), 1, F32, "wide"), ((1, 512, 512, 64), 3, F32, "wide"),
    ((8, 512, 512, 39), 3, BF16, "narrow"), ((8, 32, 32, 1024), 1, BF16, "wide"),
    ((8, 1024, 1024, 39), 3, BF16, "narrow"), ((8, 512, 512, 64), 1, BF16, "wide"),
    ((8, 1024, 1024, 32), 3, BF16, "wide"),
    ((128, 128, 128, 36), 3, BF16, "narrow"), ((128, 16, 16, 512), 1, BF16, "wide"),
    ((128, 128, 128, 64), 3, BF16, "wide"),
]


def _item(dt):
    return torch.empty((), dtype=dt).element_size()


@pytest.mark.parametrize("shape,pad,dt,variant", SITES)
def test_fwd_plan_at_the_sites(shape, pad, dt, variant):
    """The form by the pixel's byte width; at least 2 x 132 items; at most
    16 KB of output an item; the tiles cover a row's units."""
    n, h, w, c = shape
    plan = krp._fwd_plan(n, h, w, c, pad, dt)
    assert plan["variant"] == variant
    assert plan["items"] == n * (h + 2 * pad) * plan["tiles"] >= 2 * 132
    px, wp = c * _item(dt), w + 2 * pad
    unit, units = (px, wp) if variant == "wide" else (16, -(-wp * px // 16))
    assert plan["tile"] * unit <= max(krp._FWD_ITEM, unit)
    assert (plan["tiles"] - 1) * plan["tile"] < units <= plan["tiles"] * plan["tile"]
    # a misaligned x takes the narrow form, whatever its pixel
    assert krp._fwd_plan(n, h, w, c, pad, dt, False)["variant"] == "narrow"


def _reflect(i, n):
    i = abs(i)
    return 2 * (n - 1) - i if i >= n else i


def emulate_fwd(x, pad, plan, offset):
    """The kernel's forward on the bytes of x placed ``offset`` bytes past a
    16-byte boundary -> (y as bytes, times each output byte was written).
    Every source vector a narrow chunk loads is checked to lie in the
    16-byte-aligned extent of x."""
    n, h, w, c = x.shape
    es = x.element_size()
    px, hp, wp = c * es, h + 2 * pad, w + 2 * pad
    rows, rb = n * hp, wp * px
    xb = x.contiguous().view(torch.uint8).numpy().reshape(-1)
    total = rows * rb
    y = np.zeros(total, np.uint8)
    hits = np.zeros(total, np.int64)
    lo, hi = offset // 16 * 16, -(-(offset + xb.size) // 16) * 16   # the aligned extent

    def src(row, col):   # byte of x where output pixel (row, col) reads
        b, yo = divmod(row, hp)
        return ((b * h + _reflect(yo - pad, h)) * w + _reflect(col - pad, w)) * px

    for item in range(plan["items"]):
        row, k = divmod(item, plan["tiles"])
        if plan["variant"] == "wide":
            cv = px // 16
            x0 = k * plan["tile"]
            for i in range(min(plan["tile"], wp - x0) * cv):
                j, v = divmod(i, cv)
                s, d = src(row, x0 + j) + 16 * v, (row * wp + x0) * px + 16 * i
                y[d:d + 16] = xb[s:s + 16]
                hits[d:d + 16] += 1
            continue
        rb0 = row * rb
        qa, qb = -(-rb0 // 16), -(-(rb0 + rb) // 16)
        q0 = qa + k * plan["tile"]
        for q in range(q0, min(q0 + plan["tile"], qb)):
            o = 16 * q - rb0
            j, j1 = o // px, (o + 15) // px
            if o + 16 <= rb and (j == j1 or (j >= pad and j1 < w + pad)):
                s = src(row, j) + o - j * px
                a = offset + s
                assert lo <= a // 16 * 16 and -(-(a + 16) // 16) * 16 <= hi
                chunk = xb[s:s + 16]
            else:
                parts = []
                for e in range(0, 16, es):
                    r, oe = row, o + e
                    while oe >= rb:
                        oe, r = oe - rb, r + 1
                    if r >= rows:
                        break
                    je = oe // px
                    s = src(r, je) + oe - je * px
                    parts.append(xb[s:s + es])
                chunk = np.concatenate(parts)
            b = 16 * q
            y[b:b + chunk.size] = chunk
            hits[b:b + chunk.size] += 1
    return y, hits


# (N, H, W, C), pad: the stems' pixels (39 and 36 channels) at small sizes,
# resblock and head pixels, overlapping mirrors (pad 3 with H or W = 4), W =
# pad + 1, one image, odd pixels (3 and 5 channels), pixels under 16 bytes
EMULATED = [((2, 5, 7, 39), 3), ((1, 9, 6, 36), 3), ((2, 4, 6, 64), 1), ((1, 4, 4, 8), 3),
            ((2, 6, 4, 16), 3), ((1, 3, 2, 32), 1), ((1, 5, 7, 3), 1), ((3, 4, 5, 5), 3),
            ((1, 2, 3, 1), 1), ((2, 7, 9, 1024), 2)]


@pytest.mark.parametrize("dt", [F32, BF16])
@pytest.mark.parametrize("offset", [0, 4])
@pytest.mark.parametrize("shape,pad", EMULATED)
def test_fwd_emulation_writes_each_byte_once_as_the_plain_pad(shape, pad, offset, dt):
    """Each output byte written once, by the item that owns it, with the
    plain pad's value; a narrow chunk's vectors inside x's aligned extent."""
    n, h, w, c = shape
    x = torch.randn(shape).to(dt)
    plan = krp._fwd_plan(n, h, w, c, pad, dt, offset % 16 == 0)
    y, hits = emulate_fwd(x, pad, plan, offset)
    assert (hits == 1).all()
    want = krp.reflect_pad_plain(x, pad).contiguous().view(torch.uint8).numpy().reshape(-1)
    assert np.array_equal(y, want)


def test_reflect_pad_on_the_cpu_is_f_pad_and_counts_nothing():
    """On a CPU tensor, nnops.reflect_pad is F.pad's reflect pad (forward
    and gradient) and launches nothing; the forward and backward wrappers
    are registered with the launch counters and the intercepted calls."""
    assert kcalls.COUNTED["reflect_pad_fwd"] == (krp, "reflect_pad_fwd")
    assert (krp, "reflect_pad_fwd") in kcalls.CALLED
    before, variants = kcalls.read_launches(), kcalls.read_variants()
    assert variants["reflect_pad_fwd"].keys() == {"wide", "narrow"}
    x = torch.randn(2, 5, 7, 6, requires_grad=True)
    y = nnops.reflect_pad(x, 3)
    want = F.pad(x.detach().permute(0, 3, 1, 2), (3,) * 4, mode="reflect").permute(0, 2, 3, 1)
    assert torch.equal(y, want)
    g = torch.randn(y.shape)
    (gx,) = torch.autograd.grad(y, x, g)
    xr = x.detach().permute(0, 3, 1, 2).requires_grad_(True)
    (gr,) = torch.autograd.grad(F.pad(xr, (3,) * 4, mode="reflect"), xr, g.permute(0, 3, 1, 2))
    torch.testing.assert_close(gx, gr.permute(0, 2, 3, 1), rtol=0, atol=1e-6)
    assert kcalls.read_launches() == before and kcalls.read_variants() == variants


@pytest.mark.parametrize("bad", ["h", "rank", "layout", "dtype"])
def test_reflect_pad_fwd_rejects_what_it_does_not_take(bad):
    x = {"h": torch.zeros(1, 2, 6, 2), "rank": torch.zeros(6, 6, 2),
         "layout": torch.zeros(1, 6, 6, 2).permute(0, 2, 1, 3),
         "dtype": torch.zeros(1, 6, 6, 2, dtype=torch.float64)}[bad]
    with pytest.raises(ValueError):
        krp.reflect_pad_fwd(x, 2)


def test_fwd_call_bytes_read_x_once_and_write_y_once():
    x = torch.zeros(2, 5, 7, 39, dtype=BF16)
    assert bounds.call_bytes("reflect_pad_fwd", x, 3) == 2 * (2 * 5 * 7 + 2 * 11 * 13) * 39
    assert bounds.call_bytes("reflect_pad_fwd", x, pad=1) == 2 * (2 * 5 * 7 + 2 * 7 * 9) * 39
