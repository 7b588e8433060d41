"""The index map of the ``quantize_int8`` kernel, emulated on the CPU with
numpy and held exactly to the JAX oracle (``repro.core.compression``).

On the card (``kernels/csrc/codec.cu``) a group of g <= 128 values takes W
lanes, W the next power of two of ceil(g/4), and segment lane s holds the
group's values 4s .. 4s+3, so a warp holds 32/W groups:

- the grid is 2-D: x over a row's ng*W lanes (group j = lane / W), y over
  rows, capped at 65,535 blocks and grid-striding past it; the row loop's
  trip count is the block's, so every warp reaches the shuffles whole;
- the host makes the block (bx, by) a multiple of W lanes wide and of 32
  threads: 256 threads where it can, fewer rows when bx * by would leave a
  partial warp, and a row padded to whole warps when even one row would;
- the vector path (d and g multiples of 4, x aligned to 4 values, q to 4
  bytes) loads a lane's 4 values at once and stores its 4 int8 as one
  word; the scalar path loads and stores them one at a time;
- the amax is a max.NaN reduction by ``shfl_xor`` over offsets W/2 .. 1,
  within the warp (threads in order ty * bx + tx); at W = 32 (one group a
  warp) one ``redux.sync`` unsigned max over the bits of |x| instead, which
  is max.NaN because those bits order as the values do and a NaN's lie
  above +inf's;
- values past g, past d (a padded tail group), lanes past ng (a padded
  block) and rows past ``rows`` read 0 and store nothing; the segment's
  first lane stores the scale.

Here the same steps run over every thread of the grid, the shuffles as
index permutations of each warp's 32 lanes.  The emulation checks that no
shuffle partner lies in another group, that every int8 and every scale is
written exactly once, and that q and the scales equal the JAX oracle's (NaN
scales where the oracle's are NaN).  Tolerance: exact (every bit).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _codec_inputs import nonfinite_input, same_floats
from repro.core import compression as J

LANES = 32
Q_THREADS = 256
GRID_Y = 65535
INV127 = np.float32(1.0 / 127.0)


def group_lanes(g: int) -> int:
    """W: the next power of two of ceil(g / 4)."""
    w = 1
    while 4 * w < g:
        w <<= 1
    return w


def block_shape(lanes: int):
    """(bx, by) for a row of ``lanes`` lanes, as the host picks it."""
    bx = min(lanes, Q_THREADS)
    by = Q_THREADS // bx
    while by > 1 and bx * by % LANES:
        by -= 1
    if bx * by % LANES:
        bx = -(-bx // LANES) * LANES
    return bx, by


def takes_vector_path(d, g, x_addr, q_addr, esize):
    """The host's choice: 4 values a load, 4 int8 a store."""
    return (d % 4 == 0 and g % 4 == 0 and x_addr % (4 * esize) == 0
            and q_addr % 4 == 0)


def quant_value(v, scale):
    """rint(v / scale) in f32, NaN -> 0, clipped to +-127."""
    with np.errstate(invalid="ignore", divide="ignore"):
        r = np.rint(np.float32(v) / np.float32(scale))
    r = np.where(np.isnan(r), np.float32(0), r)
    return np.clip(r, -127, 127).astype(np.int8)


def emulate(x: np.ndarray, group: int, vec: bool, grid_y: int = GRID_Y):
    """The kernel on x (rows, d) f32 -> (q (rows, d) int8, scales (rows, ng)
    f32, writes of each int8, writes of each scale)."""
    rows, d = x.shape
    g = min(group, d)
    ng = -(-d // g)
    w = group_lanes(g)
    lanes = ng * w
    bx, by = block_shape(lanes)
    assert bx % w == 0 and bx * by % LANES == 0 and bx * by <= Q_THREADS
    grid_x = -(-lanes // bx)
    grid_y = min(-(-rows // by), grid_y)
    q = np.zeros((rows, d), np.int8)
    scales = np.zeros((rows, ng), np.float32)
    q_writes = np.zeros((rows, d), np.int64)
    s_writes = np.zeros((rows, ng), np.int64)
    ty, tx = np.meshgrid(np.arange(by), np.arange(bx), indexing="ij")
    ty, tx = ty.ravel(), tx.ravel()         # thread order ty * bx + tx
    for bxi in range(grid_x):
        lane = bxi * bx + tx
        j, i = lane // w, 4 * (lane % w)
        col = j * g + i
        for byi in range(grid_y):
            for r0 in range(byi * by, rows, grid_y * by):   # block-uniform
                r = r0 + ty
                live = (r < rows) & (j < ng) & (i < g) & (col < d)
                rr = np.where(live, r, 0)
                v = np.zeros((by * bx, 4), np.float32)
                ok = np.zeros((by * bx, 4), bool)
                for t in range(4):
                    ok[:, t] = live & (i + t < g) & (col + t < d)
                    if vec:     # a lane's 4 values lie in its group and row
                        assert np.array_equal(ok[:, t], live)
                    cc = np.where(ok[:, t], col + t, 0)
                    v[:, t] = np.where(ok[:, t], x[rr, cc], np.float32(0))
                amax = np.abs(v).max(axis=1)            # max.NaN
                key = np.stack([r, j], 1).reshape(-1, LANES, 2)
                warp_amax = amax.reshape(-1, LANES)
                if w == LANES:              # redux.sync.max over the bits
                    assert (key == key[:, :1]).all()
                    bits = warp_amax.view(np.uint32).max(axis=1)
                    warp_amax = np.repeat(bits[:, None], LANES, 1).view(
                        np.float32)
                off = w // 2 if w < LANES else 0
                while off:
                    partner = np.arange(LANES) ^ off
                    assert np.array_equal(key, key[:, partner])
                    warp_amax = np.maximum(warp_amax, warp_amax[:, partner])
                    off //= 2
                amax = warp_amax.ravel()
                scale = np.maximum(amax, np.float32(1e-8)) * INV127
                for t in range(4):
                    m = ok[:, t]
                    q[r[m], col[m] + t] = quant_value(v[m, t], scale[m])
                    np.add.at(q_writes, (r[m], col[m] + t), 1)
                first = live & (i == 0)
                scales[r[first], j[first]] = scale[first]
                np.add.at(s_writes, (r[first], j[first]), 1)
    return q, scales, q_writes, s_writes


@functools.lru_cache(maxsize=None)
def _oracle(group):
    return jax.jit(functools.partial(J.quantize_int8, group=group))


def _input(rows, d, fill, seed):
    if fill == "nonfinite":
        return nonfinite_input((rows, d), seed)
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(rows, d)) * 3.0).astype(np.float32)


def _check(x, group, vec, grid_y=GRID_Y):
    q, s, qw, sw = emulate(x, group, vec, grid_y)
    assert (qw == 1).all() and (sw == 1).all()      # each exactly once
    qj, sj = _oracle(group)(jnp.asarray(x))
    assert np.array_equal(q, np.asarray(qj))
    assert same_floats(s, np.asarray(sj))


@pytest.mark.parametrize("vec", [True, False])
@pytest.mark.parametrize("d", [48, 64, 200, 256, 960])
@pytest.mark.parametrize("group", [32, 48, 64, 128])
def test_index_map_covers_each_value_once_and_matches_oracle(group, d, vec):
    """Both paths at g (= min(group, d)) 32 / 48 / 64 / 128 and d 48 / 64 /
    200 / 256 / 960: padded tail groups (d = 200, 960 at g = 128; 200 at
    48), warps of 1, 2 and 4 groups, rows that leave a block part-filled."""
    _check(_input(7, d, "normal", seed=group * d), group, vec)


@pytest.mark.parametrize("rows,d,group", [(9, 960, 128), (21, 200, 128),
                                          (14, 64, 64), (7, 48, 128)])
def test_index_map_nonfinite(rows, d, group):
    """NaN, -NaN, +-inf and whole NaN groups beside finite ones: the
    shuffle reduction keeps a NaN, the group's int8 are 0."""
    for vec in (True, False):
        _check(_input(rows, d, "nonfinite", seed=rows), group, vec)


@pytest.mark.parametrize("rows,d,group", [(11, 64, 64), (5, 960, 128),
                                          (9, 50, 128), (6, 90, 45),
                                          (4, 13, 128)])
def test_grid_stride_odd_widths_and_small_groups(rows, d, group):
    """The y grid capped at 2 blocks, so the row loop strides; odd widths
    and groups (the scalar path: d = 50, 13; g = 45; W = 4 at g = 13)."""
    vec = d % 4 == 0 and min(group, d) % 4 == 0
    _check(_input(rows, d, "normal", seed=d), group, vec, grid_y=2)


def test_block_shapes_are_whole_warps_of_whole_segments():
    """Every ng * W the kernel meets gives a block of whole warps, a
    multiple of W lanes wide, at most 256 threads, and padding of less
    than a warp per row."""
    for g in range(1, 129):
        w = group_lanes(g)
        assert 4 * w >= g and (w == 1 or 4 * (w // 2) < g)
        for ng in range(1, 70):
            bx, by = block_shape(ng * w)
            assert bx % w == 0 and bx * by % LANES == 0
            assert bx * by <= Q_THREADS
            assert bx - min(ng * w, Q_THREADS) < LANES
    assert block_shape(16) == (16, 16)      # cut2 and (8, 64): 2 groups/warp
    assert block_shape(64) == (64, 4)       # cut6: 2 warps a row
    assert block_shape(256) == (256, 1)     # lm_smollm: a row a block


@pytest.mark.parametrize("d,g,x_addr,q_addr,esize,want", [
    (256, 128, 0, 0, 4, True), (256, 128, 8, 0, 4, False),
    (256, 128, 8, 0, 2, True), (256, 128, 4, 0, 2, False),
    (256, 128, 0, 2, 4, False), (50, 50, 0, 0, 4, False),
    (90, 45, 0, 0, 2, False), (200, 128, 0, 0, 2, True)])
def test_vector_path_choice(d, g, x_addr, q_addr, esize, want):
    """4 values a load only when d and g are multiples of 4, x is aligned
    to 4 values (16 bytes f32, 8 bytes bf16 / f16) and q to 4 bytes."""
    assert takes_vector_path(d, g, x_addr, q_addr, esize) is want
