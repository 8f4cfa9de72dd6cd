"""The launch plans of the Hopper kernels, and the IN backward's reduction
order, on the CPU.

``kernels/conv_in._plan`` and ``kernels/instance_norm._bwd_plan`` pick the
variant, the tile and the cluster of a call from its shape alone; here they
are held to the main paths' shapes and to odd ones: every pixel and channel
covered once, the cluster within Hopper's limits. The IN backward kernel
sums gm and gm * xhat per block in a fixed order and adds the blocks in
rank order; ``emulate_bwd`` repeats that order in plain PyTorch and is held
against ``instance_norm_bwd_plain`` and the JAX package's ``_run_bwd``
(Pallas, interpret mode).
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from neurips18_hierchical_image_manipulation_tpu.ops.pallas import instance_norm as pin
from neurips18_hierchical_image_manipulation_tpu_torch.kernels import conv_in as kconv
from neurips18_hierchical_image_manipulation_tpu_torch.kernels import instance_norm as kin

F32, BF16 = torch.float32, torch.bfloat16
# fp32: the same closed form, summed in another order. dx is O(1) here.
IN_BWD_ATOL = 1e-5

# ---------------------------------------------------------------- conv plan

# (N, H, W, Cin, Cout, dtype) -> variant, cluster
CONV_CASES = [
    ((32, 16, 32, 1024, 1024, BF16), "wgmma", 4),   # the resblock roofline path
    ((4, 16, 32, 1024, 1024, BF16), "wgmma", 4),
    ((64, 9, 17, 96, 40, BF16), "wgmma", 2),        # H*W, Cin off the tile
    ((16, 32, 48, 64, 64, BF16), "wgmma", 1),       # 16 tiles: two launches
    ((4, 6, 300, 64, 64, BF16), "wgmma", 1),        # a row wider than a tile
    ((1, 16, 32, 1024, 1024, BF16), "mma", 1),      # bs 1: too few blocks
    ((2, 8, 16, 128, 128, BF16), "mma", 1),
    ((1, 5, 7, 12, 20, BF16), "mma", 1),            # no 16-byte rows
    ((64, 9, 17, 12, 40, BF16), "mma", 1),
    ((32, 16, 32, 1024, 1024, F32), "fma", 1),      # fp32: the parity tier
    ((1, 5, 7, 12, 20, F32), "fma", 1),
]


@pytest.mark.parametrize("shape,variant,cluster", CONV_CASES)
def test_conv_plan_variant_and_cluster(shape, variant, cluster):
    plan = kconv._plan(*shape)
    assert plan["variant"] == variant
    assert plan["cluster"] == cluster
    assert 1 <= plan["cluster"] <= 8
    assert plan["tiles"] % plan["cluster"] == 0


@pytest.mark.parametrize("shape", [c[0] for c in CONV_CASES] + [
    (8, 1, 128, 8, 8, BF16), (8, 3, 129, 8, 8, BF16), (70, 2, 2, 8, 8, BF16)])
def test_conv_plan_tiles_cover_the_plane_once(shape):
    n, h, w = shape[:3]
    plan = kconv._plan(*shape)
    hits = np.zeros((h, w), np.int64)
    if plan["variant"] == "wgmma":
        rb, wt = plan["tile"]
        assert rb * wt <= 128 and wt <= 128
        tiles_w = -(-w // wt)
        for t in range(plan["tiles"]):
            h0, w0 = (t // tiles_w) * rb, (t % tiles_w) * wt
            hits[h0 : h0 + rb, w0 : w0 + wt] += 1
        assert n * plan["tiles"] * -(-shape[4] // 256) >= kconv._MIN_BLOCKS
    else:
        flat, px = hits.reshape(-1), plan["pixels"]
        for t in range(plan["tiles"]):
            flat[t * px : t * px + px] += 1
    assert (hits == 1).all()


# the fp32 shapes of chip_smoke.CONV_IN_SHAPES
FMA_SHAPES = [(1, 16, 32, 1024, 1024), (2, 9, 17, 96, 40), (2, 8, 16, 128, 128),
              (1, 5, 7, 12, 20), (4, 16, 32, 1024, 1024), (64, 9, 17, 96, 40),
              (16, 32, 48, 64, 64), (1, 6, 9, 7, 10)]


def test_fma_plan_fills_the_card_at_bs1():
    """The bs-1 bottleneck: 4 x 4 tiles of 128 x 256, K split 8 ways (the
    splits' sums and the statistics take two more launches)."""
    plan = kconv._plan(1, 16, 32, 1024, 1024, F32)
    blocks = plan["tiles"] * plan["k_split"] * -(-1024 // kconv._FMA_TILE[1])
    assert blocks >= 128
    assert (plan["k_split"], plan["cluster"], plan["launches"]) == (8, 1, 3)


@pytest.mark.parametrize("shape", FMA_SHAPES)
def test_fma_plan_split_cluster_and_cover(shape):
    n, h, w, cin, cout = shape
    plan = kconv._plan(*shape, F32)
    assert plan["variant"] == "fma"
    ks, cl, mt = plan["k_split"], plan["cluster"], plan["tiles"]
    # whole K steps: the 9 * ceil(Cin / 32) steps split evenly
    steps = 9 * -(-cin // kconv._FMA_K)
    assert ks in (1, 2, 4, 8) and steps % ks == 0
    assert ks == 1 or steps // ks >= 4
    # no cluster: one unsplit tile holds the plane, or more launches merge
    assert cl == 1
    assert plan["launches"] == (3 if ks > 1 else 1 if mt == 1 else 2)
    # the tiles cover each plane once, and the splits' row slices each tile once
    hits = np.zeros(h * w, np.int64)
    px = plan["pixels"]
    for t in range(mt):
        for q in range(ks):
            hits[t * px + q * px // ks: t * px + (q + 1) * px // ks] += 1
    assert (hits == 1).all()
    # more blocks than the tiles alone only where they were too few
    blocks = n * mt * -(-cout // kconv._FMA_TILE[1])
    assert ks == 1 or blocks * ks // 2 < kconv._FMA_MIN_BLOCKS


# ---------------------------------------------------------------- IN backward plan

def step_sites():
    """The 39 IN sites of one 512x256 bs-1 train step: 27 of the generator,
    6 of the discriminator on the fake (N 1) and 6 on [real; fake] (N 2)."""
    g = [(1, 256 >> i, 512 >> i, 64 << i) for i in range(5)]
    g += [(1, 16, 32, 1024)] * 18
    g += [(1, 256 >> i, 512 >> i, 64 << i) for i in range(3, -1, -1)]
    d = [(65, 129, 128), (33, 65, 256), (34, 66, 512), (33, 65, 128), (17, 33, 256),
         (18, 34, 512)]
    return g + [(n, *s) for n in (1, 2) for s in d]


@pytest.mark.parametrize("dt,split", [(F32, 6), (BF16, 4)])
def test_bwd_plan_on_the_train_step(dt, split):
    """fp32: the stem and first down (and the last two ups) and the first D
    layer at 65x129 do not fit 16 blocks; bf16 holds twice the rows."""
    sites = step_sites()
    assert len(sites) == 39
    variants = [kin._bwd_plan(*s, dt)["variant"] for s in sites]
    assert variants.count("split") == split
    assert variants.count("cluster") == 39 - split
    assert kin._bwd_plan(1, 64, 128, 256, F32)["cluster"] == 16
    assert kin._bwd_plan(1, 256, 512, 64, dt)["variant"] == "split"


@pytest.mark.parametrize("dt", [F32, BF16])
@pytest.mark.parametrize("shape", step_sites()[:5] + step_sites()[27:33] + [
    (1, 5, 7, 48), (2, 5, 7, 3), (3, 1, 1, 8), (1, 9, 11, 100), (1, 96, 96, 128)])
def test_bwd_plan_covers_rows_once(dt, shape):
    n, h, w, c = shape
    hw = h * w
    plan = kin._bwd_plan(n, h, w, c, dt)
    item = torch.empty((), dtype=dt).element_size()
    blocks, chunk = plan["splits"], plan["chunk"]
    assert (blocks - 1) * chunk < hw <= blocks * chunk  # no empty block, no row left
    if plan["variant"] == "cluster":
        assert plan["cluster"] == blocks and 1 <= blocks <= 16
        assert c % (16 // item) == 0
        assert chunk * 32 * item * 3 <= kin._SLAB
    else:
        assert plan["cluster"] == 1


# ---------------------------------------------------------------- reduction order

def emulate_bwd(x, y, g, mean, rstd, act, plan):
    """The fp32 backward in the kernels' summation order: each block
    (cluster rank or split) owns ``chunk`` rows; 32 row lanes each sum their
    rows in order, a warp's 4 lanes combine by a shuffle tree (xor 1, then
    2), the 8 warps are added in order, and the blocks in rank order."""
    n, h, w, c = x.shape
    hw, lanes = h * w, 32
    gm = kin._mask(g, y, act)
    mu, rs = mean.reshape(n, 1, 1, c), rstd.reshape(n, 1, 1, c)
    xh = (x - mu) * rs
    terms = torch.stack([gm, gm * xh], 1).reshape(n, 2, hw, c)
    total = torch.zeros(n, 2, c)
    for b in range(plan["splits"]):
        rows = terms[:, :, b * plan["chunk"] : min(hw, (b + 1) * plan["chunk"])]
        lane = torch.zeros(n, 2, lanes, c)
        for i in range(0, rows.shape[2], lanes):
            seg = rows[:, :, i : i + lanes]
            lane[:, :, : seg.shape[2]] = lane[:, :, : seg.shape[2]] + seg
        lane = lane.reshape(n, 2, 8, 4, c)
        lane = lane + lane[:, :, :, [1, 0, 3, 2]]
        lane = lane + lane[:, :, :, [2, 3, 0, 1]]
        block = torch.zeros(n, 2, c)
        for wi in range(8):
            block = block + lane[:, :, wi, 0]
        total = total + block
    means = (total / hw).reshape(n, 2, 1, 1, c)
    return (gm - means[:, 0] - xh * means[:, 1]) * rs


@pytest.fixture
def interpret():
    old = pin.INTERPRET
    pin.INTERPRET = True
    yield
    pin.INTERPRET = old


# a cluster of 4 blocks, the bottleneck (a cluster of 5, 103 rows a block),
# a split site (18 blocks needed)
@pytest.mark.parametrize("shape,variant", [((2, 8, 16, 128), "cluster"),
                                           ((1, 16, 32, 1024), "cluster"),
                                           ((1, 96, 96, 128), "split")])
@pytest.mark.parametrize("act", ["none", "relu", "lrelu"])
def test_bwd_reduction_order_matches_plain_and_jax(interpret, shape, variant, act):
    plan = kin._bwd_plan(*shape, F32)
    assert plan["variant"] == variant and plan["splits"] > 1
    rng = np.random.RandomState(3)
    x = torch.from_numpy((rng.randn(*shape) * 2 + 0.5).astype(np.float32))
    g = torch.from_numpy(rng.randn(*shape).astype(np.float32))
    y, mean, rstd = kin.instance_norm(x, act)
    got = emulate_bwd(x, y, g, mean, rstd, act, plan)
    plain, _ = kin.instance_norm_bwd_plain(x, y, g, mean, rstd, act)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=IN_BWD_ATOL, rtol=0)
    n, h, w, c = shape
    gm = kin._mask(g, y, act).numpy().reshape(n, h * w, c)
    stat = lambda t: jnp.broadcast_to(jnp.asarray(t.numpy())[:, None, :], (n, 8, c))  # noqa: E731
    want = pin._run_bwd(jnp.asarray(x.numpy().reshape(n, h * w, c)), jnp.asarray(gm),
                        stat(mean), stat(rstd))
    np.testing.assert_allclose(got.numpy().reshape(n, h * w, c), np.asarray(want),
                               atol=IN_BWD_ATOL, rtol=0)
