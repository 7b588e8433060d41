"""Codec inputs and comparisons shared by the port's CPU and card tests
(numpy only: the card machine has no jax)."""
import numpy as np

NEG_NAN = np.uint32(0xFFC00000).view(np.float32)   # a NaN with its sign set


def nonfinite_input(shape, seed):
    """Normal values (x 3) with, row by row in turn, in the row's first
    quantisation group (g = min(128, d)): one NaN; three NaNs; a -NaN; +inf
    beside -inf (in the row's last group when it has two or more); a whole
    NaN group; a NaN beside +inf; nothing.  A row of two or more groups
    keeps finite groups beside its non-finite one."""
    rng = np.random.default_rng(seed)
    a = (rng.normal(size=shape) * 3.0).astype(np.float32)
    d = shape[-1]
    g = min(128, d)
    rows = a.reshape(-1, d)                       # a view: writes go to a
    for r in range(rows.shape[0]):
        cols = rng.permutation(g)[:3]
        kind = r % 7
        if kind == 0:
            rows[r, cols[0]] = np.nan
        elif kind == 1:
            rows[r, cols] = np.nan
        elif kind == 2:
            rows[r, cols[0]] = NEG_NAN
        elif kind == 3:
            rows[r, cols[0]] = np.inf
            rows[r, cols[1] if d == g else d - 1] = -np.inf
        elif kind == 4:
            rows[r, :g] = np.nan
        elif kind == 5:
            rows[r, cols[:2]] = (np.nan, np.inf)
    return a


def same_floats(a, b) -> bool:
    """Equal under the codec's non-finite contract: NaN exactly where the
    other is NaN (payloads aside), every other element bit for bit."""
    a = np.ascontiguousarray(a, np.float32)
    b = np.ascontiguousarray(b, np.float32)
    if a.shape != b.shape:
        return False
    nan = np.isnan(a)
    return (np.array_equal(nan, np.isnan(b))
            and np.array_equal(a.view(np.uint32)[~nan],
                               b.view(np.uint32)[~nan]))


def same_wire(a, b, g, k) -> bool:
    """Equal packed topk_int8 buffers (..., ng*wpg): bitmap and value words
    bit for bit, scale words as :func:`same_floats`."""
    bw = -(-g // 32)
    wpg = bw + 1 + -(-k // 4)
    a = np.ascontiguousarray(a, np.int32).reshape(-1, wpg)
    b = np.ascontiguousarray(b, np.int32).reshape(-1, wpg)
    if a.shape != b.shape:
        return False
    ints = np.arange(wpg) != bw
    return (np.array_equal(a[:, ints], b[:, ints])
            and same_floats(a[:, bw].view(np.float32),
                            b[:, bw].view(np.float32)))
