"""The launch plans of the IN forward and the reflect-pad backward, and
their kernels' reduction and fold orders, on the CPU.

``kernels/instance_norm._fwd_plan`` picks the IN forward's variant (one
launch on a thread-block cluster, or two split launches) and
``kernels/reflect_pad._plan`` the reflect-pad backward's (bulk copies
through a shared-memory ring, or a gather) from the shape alone; here they
are held to the main paths' shapes and to odd ones. ``emulate_fwd`` repeats
the forward kernel's summation order in plain PyTorch (cluster: each row
lane's rows in order, a shuffle tree, the 8 warps in order, the blocks in
rank order, then the same for the centred squares; split: Chan partials of
four-row groups merged in a fixed order) and ``emulate_pad_bwd`` the bulk
form's fold, item by item from the plan's segments; both are held against
the plain versions and the JAX package's Pallas kernels in interpret mode.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from neurips18_hierchical_image_manipulation_tpu.ops.pallas import instance_norm as pin
from neurips18_hierchical_image_manipulation_tpu.ops.pallas import reflect_pad as prp
from neurips18_hierchical_image_manipulation_tpu_torch.kernels import instance_norm as kin
from neurips18_hierchical_image_manipulation_tpu_torch.kernels import reflect_pad as krp

F32, BF16 = torch.float32, torch.bfloat16
# fp32: the same two-pass (or Chan) statistics summed in another order; y is
# O(1) here
IN_FWD_ATOL = 1e-5


@pytest.fixture
def interpret():
    olds = (pin.INTERPRET, prp.INTERPRET)
    pin.INTERPRET = prp.INTERPRET = True
    yield
    pin.INTERPRET, prp.INTERPRET = olds


# ---------------------------------------------------------------- IN forward plan

def generator_sites(bs, h, w, ngf=64, n_down=4, n_blocks=9):
    """The IN sites of one GlobalGenerator forward, in order (27 at full
    width)."""
    sites = [(bs, h >> i, w >> i, ngf << i) for i in range(n_down + 1)]
    sites += [(bs, h >> n_down, w >> n_down, ngf << n_down)] * (2 * n_blocks)
    sites += [(bs, h >> i, w >> i, ngf << i) for i in range(n_down - 1, -1, -1)]
    return sites


# the 6 IN sites of one discriminator apply at 512x256 (2 scales x 3 layers)
D_SITES = [(65, 129, 128), (33, 65, 256), (34, 66, 512), (33, 65, 128), (17, 33, 256),
           (18, 34, 512)]


def step_sites():
    """The 39 IN sites of one 512x256 bs-1 train step: the generator's 27,
    D on the fake (N 1) and D on [real; fake] (N 2)."""
    return generator_sites(1, 256, 512) + [(n, *s) for n in (1, 2) for s in D_SITES]


@pytest.mark.parametrize("dt", [F32, BF16])
def test_fwd_plan_on_the_train_step(dt):
    """The stem, the first down and the last two ups (256x512x64 and
    128x256x128) are too large for 16 blocks' slabs: split; every other
    site of the step is one cluster launch, in both dtypes."""
    sites = step_sites()
    assert len(sites) == 39
    variants = [kin._fwd_plan(*s, dt)["variant"] for s in sites]
    split = [s for s, v in zip(sites, variants) if v == "split"]
    assert split == [(1, 256, 512, 64), (1, 128, 256, 128), (1, 128, 256, 128),
                     (1, 256, 512, 64)]
    assert variants.count("cluster") == 35


@pytest.mark.parametrize("bs,hw,split", [(1, (256, 512), 4), (8, (256, 512), 4),
                                         (1, (512, 512), 6)])
def test_fwd_plan_on_the_serving_forward(bs, hw, split):
    """27 sites a forward at 512x256 (bs 1 and 8): the two largest
    resolutions split, the rest one cluster launch each; in the serving
    CLI's 512x512 bbox windows the three largest split."""
    sites = generator_sites(bs, *hw)
    assert len(sites) == 27
    variants = [kin._fwd_plan(*s, F32)["variant"] for s in sites]
    assert variants.count("split") == split
    assert variants[:2] == ["split", "split"] and variants[-2:] == ["split", "split"]


@pytest.mark.parametrize("dt", [F32, BF16])
@pytest.mark.parametrize("shape", sorted(set(step_sites())) + [
    (8, 256, 512, 64), (8, 16, 32, 1024), (1, 512, 512, 64), (1, 128, 128, 256),
    (1, 5, 7, 48), (2, 5, 7, 3), (3, 1, 1, 8), (1, 9, 11, 100), (1, 96, 96, 128),
    (1, 112, 112, 32), (4, 1, 3000, 8)])
def test_fwd_plan_covers_rows_once(dt, shape):
    """Every row of a (sample, channel tile) plane in exactly one block; a
    cluster of at most 16 whose block slab fits its shared memory; a split
    block a whole number of its row lanes' passes."""
    n, h, w, c = shape
    hw = h * w
    plan = kin._fwd_plan(n, h, w, c, dt)
    item = torch.empty((), dtype=dt).element_size()
    blocks, chunk = plan["splits"], plan["chunk"]
    hits = np.zeros(hw, np.int64)
    for b in range(blocks):
        hits[b * chunk : min(hw, (b + 1) * chunk)] += 1
    assert (hits == 1).all()
    assert (blocks - 1) * chunk < hw  # no empty block
    if plan["variant"] == "cluster":
        assert plan["cluster"] == blocks and 1 <= blocks <= kin._MAX_CLUSTER
        assert c % (16 // item) == 0
        assert chunk * 32 * item <= kin._FWD_SLAB <= kin._SLAB
    else:
        assert plan["cluster"] == 1
        assert chunk % (256 // (32 // (16 // item))) == 0


# ---------------------------------------------------------------- IN forward order

def _lanes_tree(lane):
    """Lanes of a warp that share channels, summed by the kernel's xor
    shuffle tree (row-lane offsets 1, 2, ...): (..., L, c) with L row lanes
    a warp -> (..., c)."""
    off = 1
    while off < lane.shape[-2]:
        lane = lane + lane[..., torch.arange(lane.shape[-2]) ^ off, :]
        off *= 2
    return lane[..., 0, :]


def _block_sum(terms, lanes):
    """The kernel's per-block sum of (n, rows, c) terms: row lane l takes rows
    l, l + lanes, ... in order, a warp's lanes by the shuffle tree, then the
    8 warps in order."""
    n, rows, c = terms.shape
    acc = torch.zeros(n, lanes, c)
    for i in range(0, rows, lanes):
        seg = terms[:, i : i + lanes]
        acc[:, : seg.shape[1]] = acc[:, : seg.shape[1]] + seg
    warp = _lanes_tree(acc.reshape(n, 8, lanes // 8, c))
    total = torch.zeros(n, c)
    for w in range(8):
        total = total + warp[:, w]
    return total


def _chan(na, ma, qa, nb, mb, qb):
    """Chan's merge of (nb, mb, qb) into (na, ma, qa), elementwise in fp32."""
    nt = na + nb
    fb = torch.where(nt > 0, nb / torch.where(nt > 0, nt, 1.0), 0.0)
    d = mb - ma
    return nt, ma + d * fb, qa + qb + d * d * na * fb


def emulate_fwd(x, act, residual, plan, eps=kin.EPS):
    """The fp32 forward in the kernels' summation order -> (y, mean, rstd)."""
    n, h, w, c = x.shape
    hw, lanes, vec = h * w, 32, 4
    xs = x.reshape(n, hw, c)
    chunk = plan["chunk"]
    blocks = [xs[:, b * chunk : min(hw, (b + 1) * chunk)] for b in range(plan["splits"])]
    if plan["variant"] == "cluster":
        total = torch.zeros(n, c)
        for blk in blocks:                              # rank order
            total = total + _block_sum(blk, lanes)
        mean = total / hw
        total = torch.zeros(n, c)
        for blk in blocks:
            total = total + _block_sum((blk - mean[:, None]) ** 2, lanes)
        m2 = total
    else:
        parts = []
        for blk in blocks:
            rows = blk.shape[1]
            cnt = torch.zeros(n, lanes, 1)
            m, q = torch.zeros(n, lanes, c), torch.zeros(n, lanes, c)
            for g in range(0, rows, 4 * lanes):         # four-row groups
                grp = torch.zeros(n, lanes, 4, c)
                k = torch.zeros(n, lanes, 1)
                for i in range(4):
                    seg = blk[:, g + i * lanes : g + (i + 1) * lanes]
                    grp[:, : seg.shape[1], i] = seg
                    k[:, : seg.shape[1]] += 1
                t = torch.zeros(n, lanes, c)
                for i in range(4):
                    t = t + grp[:, :, i]
                mb = t * (1.0 / k.clamp_min(1))
                qb = torch.zeros(n, lanes, c)
                for i in range(4):
                    live = (k > i).float()
                    qb = qb + live * (grp[:, :, i] - mb) ** 2
                cnt, m, q = _chan(cnt, m, q, k, mb, qb)
            # lanes of a warp: lane l takes lane l + off, down to the G = 8
            # lanes of the first row lane (row lanes 4 w .. 4 w + 3)
            cnt, m, q = (t.reshape(n, 8, 4, -1) for t in (cnt, m, q))
            for off in (2, 1):
                cnt, m, q = _chan(cnt[:, :, :off], m[:, :, :off], q[:, :, :off],
                                  cnt[:, :, off : 2 * off], m[:, :, off : 2 * off],
                                  q[:, :, off : 2 * off])
            bn, bm, bq = torch.zeros(n, 1), torch.zeros(n, c), torch.zeros(n, c)
            for wi in range(8):                          # the warps in order
                bn, bm, bq = _chan(bn, bm, bq, cnt[:, wi, 0], m[:, wi, 0], q[:, wi, 0])
            parts.append((float(rows), bm, bq))
        runs = []
        for q0 in range(8):                              # every 8th split in order
            rn, rm, rq = torch.zeros(n, 1), torch.zeros(n, c), torch.zeros(n, c)
            for cnt, bm, bq in parts[q0::8]:
                rn, rm, rq = _chan(rn, rm, rq, torch.full((n, 1), cnt), bm, bq)
            runs.append((rn, rm, rq))
        tn, mean, m2 = torch.zeros(n, 1), torch.zeros(n, c), torch.zeros(n, c)
        for rn, rm, rq in runs:                          # then the 8 in order
            tn, mean, m2 = _chan(tn, mean, m2, rn, rm, rq)
    assert c % vec == 0 or plan["variant"] == "split"
    rstd = 1.0 / torch.sqrt(m2 / hw + eps)
    y = (x - mean[:, None, None]) * rstd[:, None, None]
    if residual is not None:
        y = y + residual
    if act == "relu":
        y = torch.clamp_min(y, 0.0)
    return y, mean, rstd


# a cluster of 4 blocks; the bottleneck (a cluster of 9); a plane too large
# for 16 blocks (split); channel counts off the 16-byte vectors (split; four
# four-row groups a row lane at 9x64x64x66)
@pytest.mark.parametrize("shape,variant", [((2, 8, 16, 128), "cluster"),
                                           ((1, 16, 32, 1024), "cluster"),
                                           ((1, 112, 112, 32), "split"),
                                           ((2, 24, 24, 6), "split"),
                                           ((9, 64, 64, 66), "split")])
@pytest.mark.parametrize("act", ["none", "relu"])
def test_fwd_reduction_order_matches_plain_and_jax(interpret, shape, variant, act):
    plan = kin._fwd_plan(*shape, F32)
    assert plan["variant"] == variant and plan["splits"] > 1
    rng = np.random.RandomState(7)
    x = torch.from_numpy((rng.randn(*shape) * 2 + 0.5).astype(np.float32))
    y, mean, rstd = emulate_fwd(x, act, None, plan)
    yp, mp, rp = kin.instance_norm_plain(x, act)
    np.testing.assert_allclose(y.numpy(), yp.numpy(), atol=IN_FWD_ATOL, rtol=0)
    np.testing.assert_allclose(mean.numpy(), mp.numpy(), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(rstd.numpy(), rp.numpy(), atol=0, rtol=1e-5)
    n, h, w, c = shape
    want, jm, jr = pin._run_fwd(jnp.asarray(x.numpy().reshape(n, h * w, c)), act == "relu")
    np.testing.assert_allclose(y.numpy().reshape(n, h * w, c), np.asarray(want),
                               atol=IN_FWD_ATOL, rtol=0)
    np.testing.assert_allclose(mean.numpy(), np.asarray(jm)[:, 0], atol=1e-5, rtol=0)


def test_fwd_order_with_residual_and_large_mean():
    """|mean| >> std: the cluster's centred second pass and the split form's
    Chan merges keep the variance; the residual joins before the act. y
    differs from the plain version by a few ulps of the mean (3e-5 at 300)
    times rstd (~100)."""
    rng = np.random.RandomState(8)
    for shape in ((1, 16, 32, 64), (1, 112, 112, 32)):
        x = torch.from_numpy((rng.randn(*shape) * 0.01 + 300.0).astype(np.float32))
        r = torch.from_numpy(rng.randn(*shape).astype(np.float32))
        y, mean, rstd = emulate_fwd(x, "relu", r, kin._fwd_plan(*shape, F32))
        x64 = x.double()
        m = x64.mean(dim=(1, 2))
        v = ((x64 - m[:, None, None]) ** 2).mean(dim=(1, 2))
        np.testing.assert_allclose(rstd.double().numpy(), (1 / torch.sqrt(v + 1e-5)).numpy(),
                                   rtol=1e-2)
        np.testing.assert_allclose(mean.double().numpy(), m.numpy(), atol=4 * 2.0**-15, rtol=0)
        yp = kin.instance_norm_plain(x, "relu", r)[0]
        np.testing.assert_allclose(y.numpy(), yp.numpy(), atol=1e-2, rtol=0)


# ---------------------------------------------------------------- reflect-pad plan

# (n, h, w, c, pad): the 18 resblock pads and the head pad of a 512x256
# step, the roofline tool's pads (bs 32), bf16's wider tiles, one tile with
# overlapping mirrors (h <= 2p), ragged last tiles, odd channel counts
PAD_SHAPES = [(1, 16, 32, 1024, 1), (1, 256, 512, 64, 3), (32, 16, 32, 1024, 1),
              (1, 64, 128, 64, 3), (2, 2, 3, 8, 1), (1, 4, 5, 16, 3), (2, 6, 9, 16, 2),
              (1, 3, 40, 32, 1), (1, 5, 7, 3, 1), (1, 4, 5, 3, 3), (2, 6, 9, 6, 1)]


def _pad_items(n, h, w, c, pad, plan):
    """The bulk plan's work items: (n, y, x0, x1, lo, hi, source rows)."""
    tp = plan["tile"]
    for it in range(n * h * plan["tiles"]):
        row, k = divmod(it, plan["tiles"])
        b, y = divmod(row, h)
        x0, x1 = k * tp, min(k * tp + tp, w)
        lo = 0 if x0 == 0 else x0 + pad
        hi = w + 2 * pad if x1 == w else x1 + pad
        rows = ([pad - y] if 1 <= y <= pad else []) + [y + pad] + (
            [2 * h - 2 - y + pad] if h - 1 - pad <= y <= h - 2 else [])
        yield b, y, x0, x1, lo, hi, rows


def _columns(x, w, pad):
    """The padded columns that reflect onto input column x, increasing."""
    return ([pad - x] if 1 <= x <= pad else []) + [x + pad] + (
        [2 * w - 2 - x + pad] if w - 1 - pad <= x <= w - 2 else [])


@pytest.mark.parametrize("dt", [F32, BF16])
@pytest.mark.parametrize("shape", PAD_SHAPES)
def test_pad_plan_covers_each_dx_element_once(dt, shape):
    """The bulk plan's tiles cover every dx pixel once; each item's
    segment [lo, hi) holds every padded column its pixels need and fits a
    stage's room; the ring fits the block's shared memory."""
    n, h, w, c, pad = shape
    plan = krp._plan(n, h, w, c, pad, dt)
    px = c * torch.empty((), dtype=dt).element_size()
    if px % 16:
        assert plan["variant"] == "gather"
        return
    assert plan["variant"] == "bulk"
    tp = plan["tile"]
    assert tp == w or tp > pad
    hits = np.zeros((n, h, w), np.int64)
    for b, y, x0, x1, lo, hi, rows in _pad_items(n, h, w, c, pad, plan):
        hits[b, y, x0:x1] += 1
        assert hi - lo <= tp + 2 * pad and len(rows) <= 3
        for x in range(x0, x1):
            assert all(lo <= j < hi for j in _columns(x, w, pad))
    assert (hits == 1).all()
    stage = (3 * (tp + 2 * pad) + tp) * px
    assert plan["smem"] == krp._BARS + krp._STAGES * stage <= krp._SMEM
    assert 1 <= plan["blocks"] <= n * h * plan["tiles"]


def emulate_pad_bwd(dy, pad, plan):
    """The bulk form's fold, item by item from the plan's segments: rows,
    then columns, each in increasing padded index, summed in fp32; an
    interior tile with one source row is its segment."""
    n, hp, wp, c = dy.shape
    h, w = hp - 2 * pad, wp - 2 * pad
    dx = torch.empty((n, h, w, c), dtype=dy.dtype)
    for b, y, x0, x1, lo, hi, rows in _pad_items(n, h, w, c, pad, plan):
        seg = [dy[b, i, lo:hi].float() for i in rows]
        if len(rows) == 1 and x0 > 0 and x1 < w:
            dx[b, y, x0:x1] = seg[0].to(dy.dtype)
            continue
        for x in range(x0, x1):
            acc = torch.zeros(c)
            for j in _columns(x, w, pad):
                r = torch.zeros(c)
                for s in seg:
                    r = r + s[j - lo]
                acc = acc + r
            dx[b, y, x] = acc.to(dy.dtype)
    return dx


@pytest.mark.parametrize("shape", [s for s in PAD_SHAPES if s[3] % 4 == 0 and s[0] * s[1] <= 64])
def test_pad_bulk_fold_equals_plain(shape):
    n, h, w, c, pad = shape
    plan = krp._plan(n, h, w, c, pad, F32)
    rng = np.random.RandomState(9)
    dy = torch.from_numpy(rng.randn(n, h + 2 * pad, w + 2 * pad, c).astype(np.float32))
    got = emulate_pad_bwd(dy, pad, plan)
    assert torch.equal(got, krp.reflect_pad_bwd_plain(dy, pad))  # the same order: exact
    bf = dy.to(BF16)
    got = emulate_pad_bwd(bf, pad, krp._plan(n, h, w, c, pad, BF16))
    assert torch.equal(got, krp.reflect_pad_bwd_plain(bf, pad))


@pytest.mark.parametrize("shape", [(2, 8, 16, 32, 1), (1, 12, 20, 8, 3)])
def test_pad_bulk_fold_matches_jax(interpret, shape):
    n, h, w, c, pad = shape
    dt = jnp.float32
    assert prp.reflect_pad_bwd_eligible((n, h, w, c), pad, np.dtype(np.float32))
    rng = np.random.RandomState(10)
    dy = rng.randn(n, h + 2 * pad, w + 2 * pad, c).astype(np.float32)
    got = emulate_pad_bwd(torch.from_numpy(dy), pad, krp._plan(n, h, w, c, pad, F32))
    want = np.asarray(prp.reflect_pad_bwd(jnp.asarray(dy, dt), pad, h, w))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
