"""The device map (``csrc/simplex_maps.cuh``) and engine MAP's store
(``csrc/map.cu``), emulated on the CPU.

Every simplex kernel on the card evaluates ``simplex_map<M>``: the map
code is a run-time switch, the dimension ``M`` a compile-time constant,
and the map's state lives in registers.  The recursion keeps no level
table: level ``k`` of ``T^dim(2^K)`` holds ``dim^k`` cubes of side
``2^lg``, ``lg = max(K - 1 - k, 1)``, so each division by a side or a
cube volume is a shift (and so is any division by a power of two known
only at run time).  Coordinates go into the zeros of ``x`` through loops
over the compile-time positions with a run-time test: the positions of
a composite piece's factor, the axis each base-``dim`` digit of a
recursion cube's number moves.  The host unpacks the int64 header and refuses
one whose level table is not the one that walk gives.  MAP stages
``MAP_STEPS * threads`` rows of ``m + 1`` int32 a block in shared memory
and stores them as one contiguous run of 16-byte pieces, the run's last
few ints one by one.

The emulation below follows the C++ line by line in int64 numpy and
asserts that every quantity the C++ keeps in int32 stays there.  It is
held bit for bit against the JAX package's
``SimplexSchedule(m, n, kind).table()`` for every kind that
``registered_kinds(m)`` names at m = 2..8, at powers of two and other
sides, and against its split pieces; MAP's store is held against the
same tables at block sizes that leave a partial last block, with the
rows past ``steps`` unwritten.  The header constants and ``MAP_STEPS``
are read out of the sources.
"""

import math
import re

import numpy as np
import pytest

from repro.core import schedule as RS
from repro_torch.core import schedule as TS
from repro_torch.kernels import _build, policy
import port_threads  # noqa: F401  (one torch thread a worker)

HEADER = (_build.CSRC / "simplex_maps.cuh").read_text()
MAP_CU = (_build.CSRC / "map.cu").read_text()
I32 = 2**31


def _define(name: str, src: str = HEADER) -> int:
    found = re.search(rf"#define {name} (\d+)", src)
    assert found, name
    return int(found.group(1))


MAX_M = _define("SIMPLEX_MAX_M")
MAX_LEVELS = _define("SIMPLEX_MAX_LEVELS")
SHARD_SLOTS = _define("SIMPLEX_SHARD_SLOTS")
SHARD_AT = 8 + (MAX_LEVELS + 1) + MAX_LEVELS
CODES = {k.lower(): int(v) for k, v in re.findall(r"\bMAP_(\w+) = (\d+)", HEADER)}
MAP_STEPS = _define("MAP_STEPS", MAP_CU)


def _i32(*arrays) -> None:
    """What the C++ holds in int32 stays in [-2^31, 2^31)."""
    for a in arrays:
        a = np.asarray(a)
        assert a.size == 0 or (a.min() >= -I32 and a.max() < I32)


# ---------------------------------------------------------------------------
# host: simplex_levels_ok, simplex_map_unpack
# ---------------------------------------------------------------------------


def _levels_ok(h, m, n, K, steps) -> bool:
    if K < 1 or K > MAX_LEVELS or (1 << K) != n:
        return False
    prefix, side = h[8:8 + MAX_LEVELS + 1], h[8 + MAX_LEVELS + 1:]
    at, cubes = 0, 1
    for k in range(K):
        lg = max(K - 1 - k, 1)
        if side[k] != 1 << lg or prefix[k] != at or m * lg > 31 or cubes >= I32:
            return False
        at += cubes << (m * lg)
        if at >= I32:
            return False
        cubes *= m
    return prefix[K] == at and at == steps


def _unpack(h, data):
    """The SimplexMap the kernel gets, as a dict; None where refused."""
    h = [int(v) for v in h]
    launch, a0, l0, a1 = h[SHARD_AT:SHARD_AT + SHARD_SLOTS]
    M = dict(code=h[0], m=h[1], n=h[2], steps=launch, w=h[4], K=h[5], npieces=h[6],
             flip=h[7], a0=a0, l0=l0, d1=a1 - l0, data=data)
    if not (2 <= M["m"] <= MAX_M and 0 <= h[3] < I32 and 1 <= M["n"] < I32
            and 0 <= M["w"] < I32):
        return None
    if not (0 <= launch < I32 and a0 >= 0 and 0 <= l0 <= launch and a1 >= 0
            and a0 + l0 <= h[3] and a1 + (launch - l0) <= h[3]):
        return None
    if M["steps"] > 0 and M["code"] in (CODES["composite"], CODES["table"]) and data is None:
        return None
    code = M["code"]
    if code in (CODES["hmap2"], CODES["rb2"], CODES["bb2"]):
        ok = M["m"] == 2 and M["w"] >= 1
    elif code in (CODES["bbmd"], CODES["table"]):
        ok = True
    elif code == CODES["hrec"]:
        ok = M["m"] >= 3 and _levels_ok(h, M["m"], M["n"], M["K"], h[3])
    elif code == CODES["composite"]:
        ok = M["npieces"] >= 1
    else:
        ok = False
    return M if ok else None


# ---------------------------------------------------------------------------
# device: simplex_map<M> over a vector of steps
# ---------------------------------------------------------------------------


def _div(a, d: int):
    """simplex_div: a shift where d is a power of two."""
    return a // d if d & (d - 1) else a >> (d.bit_length() - 1)


def _hmap2_full(wx, wy, n: int):
    lb = np.zeros_like(wy)  # 31 - clz(wy): the power of two below wy
    for s in (16, 8, 4, 2, 1):
        up = (np.maximum(wy, 1) >> (lb + s)) > 0
        lb = np.where(up, lb + s, lb)
    qb = (wx >> lb) << lb
    x = np.where(wy == 0, wx, np.where(wy == n, n // 2 + wx, wx + qb))
    y = np.where(wy == 0, wx, np.where(wy == n, n // 2 + wx, wy + 2 * qb))
    return x, y


def _hrec(idx, K: int, dim: int, first: int, x: list):
    """simplex_hrec: the level walk by shifts, the cell added into the
    zeros of x at positions first .. first + dim - 1; returns valid."""
    base = np.zeros_like(idx)
    level = np.zeros_like(idx)
    done = np.zeros(idx.shape, bool)
    cubes = 1
    for k in range(K - 1):
        size = cubes << (dim * (K - 1 - k))
        if (~done).any():
            assert size < I32  # evaluated in int32 by the steps that get here
        done |= idx - base < size
        base = np.where(done, base, base + size)
        level = np.where(done, level, level + 1)
        cubes *= dim
    lg = np.maximum(K - 1 - level, 1)
    rem = idx - base
    c = rem >> (dim * lg)
    p = rem - (c << (dim * lg))
    mask = (1 << lg) - 1
    lsum = np.zeros_like(idx)
    for q in range(len(x)):  # the compile-time positions
        j = q - first
        if 0 <= j < dim:
            loc = (p >> (j * lg)) & mask
            x[q] = x[q] + loc
            lsum = lsum + loc
    for i in range(K - 1):  # path digit i moves axis first + d by 2^(K-1) >> i
        active = i < level
        cq = c // dim
        d = first + c - cq * dim
        for q in range(len(x)):
            x[q] = x[q] + np.where(active & (d == q), (1 << (K - 1)) >> i, 0)
        c = np.where(active, cq, c)
    _i32(base, rem, p, lsum, c)
    return lsum < np.where(level == K - 1, 2, 2 << lg)


def _factor(idx, side: int, dim: int, first: int, x: list):
    """simplex_factor: a point, an interval, a triangle or the recursion,
    added into the zeros of x from position first; returns valid."""
    if side == 1:
        return np.ones(idx.shape, bool)
    if dim >= 3:
        return _hrec(idx, side.bit_length() - 1, dim, first, x)
    a, b = idx, None
    if dim == 2:
        wy = _div(idx, side // 2)
        a, row = _hmap2_full(idx - wy * (side // 2), wy, side)
        b = side - 1 - row
    for q in range(len(x)):
        if q == first:
            x[q] = a
        if q == first + 1 and dim == 2:
            x[q] = b
    return np.ones(idx.shape, bool)


def _composite(M: dict, m: int, lin):
    """simplex_composite<M>: the steps of each piece together."""
    data = np.asarray(M["data"], np.int64)
    P = M["npieces"]
    prefix = data[:P + 1]
    x = [np.zeros_like(lin) for _ in range(m)]
    valid = np.ones(lin.shape, bool)
    piece = np.searchsorted(prefix[:P], lin, side="right") - 1  # last prefix <= lin
    for lo in np.unique(piece):
        at = piece == lo
        rec = data[P + 1 + lo * (1 + 4 * m):]
        rem = lin[at] - prefix[lo]
        dyn = np.zeros_like(rem)
        top, ok = m - 1, np.ones(rem.shape, bool)
        xs = [np.zeros_like(rem) for _ in range(m)]
        for g in range(int(rec[0])):
            dim, side, delta = (int(v) for v in rec[1 + 4 * g:4 + 4 * g])
            stride = math.prod(int(rec[4 + 4 * h]) for h in range(g + 1, int(rec[0])))
            assert stride < I32
            idx = _div(rem, stride)
            rem = rem - idx * stride
            first = top - (dim - 1)
            ok = _factor(idx, side, dim, first, xs) & ok
            sumz = sum(xs[q] for q in range(first, top + 1))
            xs[top] = xs[top] + dyn + delta
            dyn = side - sumz
            top -= dim
        for q in range(m):
            x[q][at] = np.where(ok, xs[q], 0)
        valid[at] = ok
    if M["flip"]:
        x[1] = M["n"] - 1 - x[1]
    return x, valid


def device_map(M: dict, lin):
    """simplex_map<M> for every launch step in ``lin``: (coords, valid)."""
    m, n, code = M["m"], M["n"], M["code"]
    lin = lin + np.where(lin < M["l0"], M["a0"], M["d1"])
    _i32(lin)
    if code in (CODES["hmap2"], CODES["rb2"], CODES["bb2"]):
        wy = _div(lin, M["w"])
        wx = lin - wy * M["w"]
        if code == CODES["hmap2"]:
            x = list(_hmap2_full(wx, wy, n))
            valid = np.ones(lin.shape, bool)
        elif code == CODES["rb2"]:
            fold = wy <= wx
            x = [np.where(fold, n // 2 + wy, wx), np.where(fold, n // 2 + wx, wy - 1)]
            valid = np.ones(lin.shape, bool)
        else:
            x, valid = [wx, wy], wx <= wy
    elif code == CODES["bbmd"]:
        rem, x = lin, []
        for _ in range(m):
            q = _div(rem, n)
            x.append(rem - q * n)
            rem = q
        valid = sum(x) < n
    elif code == CODES["hrec"]:
        x = [np.zeros_like(lin) for _ in range(m)]
        valid = _hrec(lin, M["K"], m, 0, x)
    elif code == CODES["composite"]:
        x, valid = _composite(M, m, lin)
    else:
        rows = np.asarray(M["data"], np.int64).reshape(-1, m)
        x, valid = [rows[lin, j] for j in range(m)], np.ones(lin.shape, bool)
    _i32(*x)
    return np.stack(x + [valid.astype(np.int64)], axis=1)


def _descriptor(sched):
    d = sched.device_descriptor("cpu")
    data = None if d.data is None else d.data.numpy().ravel()
    return d.header, data


def _emulated_table(sched) -> np.ndarray:
    M = _unpack(*_descriptor(sched))
    assert M is not None
    return device_map(M, np.arange(M["steps"], dtype=np.int64)).astype(np.int32)


# ---------------------------------------------------------------------------
# MAP: the block's rows staged, then stored as 16-byte pieces
# ---------------------------------------------------------------------------


def map_store(rows: np.ndarray, threads: int, pad: int = 7) -> np.ndarray:
    """simplex_map_kernel's output for the table ``rows``: what each block
    stages and stores, in an int32 buffer ``pad`` ints longer than
    ``steps * (m + 1)`` that starts as a sentinel."""
    steps, R = rows.shape
    SENT = -(2**31)
    out = np.full(steps * R + pad, SENT, np.int64)
    per_block = MAP_STEPS * threads
    for b in range(-(-steps // per_block)):
        first = b * per_block
        n = min(per_block, steps - first)
        stage = np.full(per_block * R, SENT, np.int64)
        for t in range(threads):
            for r in range(t, n, threads):
                stage[r * R:(r + 1) * R] = rows[first + r]
        assert (first * R) % 4 == 0  # the run starts on a 16-byte boundary
        total = n * R
        pieces = total >> 2
        for i in range(pieces):  # thread i % threads
            out[first * R + 4 * i:first * R + 4 * i + 4] = stage[4 * i:4 * i + 4]
        for i in range(4 * pieces, total):
            out[first * R + i] = stage[i]
        assert (stage[:total] != SENT).all()  # the block reads only what it staged
    assert (out[steps * R:] == SENT).all()  # rows past steps are not written
    return out[:steps * R].reshape(steps, R)


# ---------------------------------------------------------------------------
# cases
# ---------------------------------------------------------------------------

# Sides per dimension: powers of two (hmap, octant) and others.
SIDES = {2: (1, 2, 3, 5, 8, 12, 16, 17), 3: (1, 2, 3, 4, 6, 8, 11, 16),
         4: (1, 2, 3, 4, 5, 8, 11), 5: (2, 3, 4, 6, 8), 6: (2, 3, 4, 5, 8),
         7: (2, 3, 4, 6), 8: (2, 3, 4, 5)}
KINDS = [(m, kind) for m in range(2, 9) for kind in RS.registered_kinds(m)]


def _sides(m: int, kind: str):
    for n in SIDES[m]:
        pow2 = n >= 2 and n & (n - 1) == 0
        if kind in ("hmap", "octant") and not pow2 or kind == "rb" and n % 2:
            continue
        yield n


def test_constants_match_the_host():
    assert MAX_M == policy.MAX_M
    assert MAX_LEVELS == TS.MAX_LEVELS
    assert CODES == TS.MAP_CODES
    assert SHARD_AT == TS.SHARD_AT
    assert SHARD_AT + SHARD_SLOTS == TS.HEADER_LEN
    assert MAP_STEPS >= 1


@pytest.mark.parametrize("m,kind", KINDS, ids=[f"m{m}-{k}" for m, k in KINDS])
def test_device_map_is_the_reference_walk(m, kind):
    for n in _sides(m, kind):
        want = np.asarray(RS.SimplexSchedule(m, n, kind).table())
        got = _emulated_table(TS.SimplexSchedule(m, n, kind))
        assert np.array_equal(got, want), (m, n, kind)


@pytest.mark.parametrize("m,n", [(2, 7), (2, 12), (3, 6), (3, 11), (4, 5), (5, 6), (6, 5),
                                 (7, 6), (8, 5)])
def test_split_pieces_are_the_reference_pieces(m, n):
    ref = RS.SimplexSchedule(m, n, "composite").split_pieces()
    ours = TS.SimplexSchedule(m, n, "composite").split_pieces()
    assert len(ours) == len(ref) > 1
    for piece, rp in zip(ours, ref):
        out = rp.map(np.arange(rp.steps))
        want = np.stack([np.asarray(c).astype(np.int64) for c in out], axis=1)
        assert np.array_equal(_emulated_table(piece), want), (m, n, piece.index)


@pytest.mark.parametrize("m", range(3, 9))
def test_level_walk_is_the_header_table(m):
    for K in range(1, MAX_LEVELS + 1):
        sched = TS.SimplexSchedule(m, 2**K, "hmap")
        if sched.steps >= I32:
            break
        h = sched.device_descriptor("cpu").header
        assert _unpack(h, None) is not None, (m, K)
        for at, delta in ((8 + 1, 1), (8 + MAX_LEVELS + 1, 2), (3, 1)):  # prefix, side, steps
            bad = h.copy()
            bad[at] += delta
            assert _unpack(bad, None) is None, (m, K, at)


def test_unpack_refusals():
    hrec = TS.SimplexSchedule(3, 8, "octant").device_descriptor("cpu").header
    flat = hrec.copy()
    flat[1] = 2  # the recursion at m = 2
    assert _unpack(flat, None) is None
    hmap2 = TS.SimplexSchedule(2, 8, "hmap").device_descriptor("cpu").header
    wide = hmap2.copy()
    wide[1] = 3  # a 2-D code at m = 3
    assert _unpack(wide, None) is None
    for code in (-1, 7):
        bad = hmap2.copy()
        bad[0] = code
        assert _unpack(bad, None) is None
    header, data = _descriptor(TS.SimplexSchedule(3, 6, "composite"))
    assert _unpack(header, data) is not None and _unpack(header, None) is None
    with pytest.raises(ValueError, match="int32"):
        TS.SimplexSchedule(8, 16, "bb").device_descriptor("cpu")  # 2^32 steps


@pytest.mark.parametrize("m,n,kind,threads", [
    (2, 16, "hmap", 32), (2, 17, "composite", 3), (2, 12, "table", 1), (3, 8, "octant", 32),
    (3, 11, "composite", 7), (4, 8, "hmap", 5), (5, 4, "bb", 24), (7, 4, "hmap", 9),
    (8, 3, "composite", 2),
])
def test_map_store_order(m, n, kind, threads):
    sched = TS.SimplexSchedule(m, n, kind)
    assert sched.steps % (MAP_STEPS * threads) != 0  # a partial last block
    rows = _emulated_table(sched)
    want = np.asarray(RS.SimplexSchedule(m, n, kind).table())
    assert np.array_equal(map_store(rows, threads), want)


# ---------------------------------------------------------------------------
# shards: the launch slots in front of the map
# ---------------------------------------------------------------------------

SHARD_KINDS = [(m, kind) for m, kind in KINDS if m <= 4]


@pytest.mark.parametrize("m,kind", SHARD_KINDS, ids=[f"m{m}-{k}" for m, k in SHARD_KINDS])
def test_shard_remap_is_the_reference_shard_walk(m, kind):
    from repro.distributed import simplex_sharding as RSS
    from repro_torch.distributed import simplex_sharding as TSS

    merged = two = 0
    for n in _sides(m, kind):
        ours, ref = TS.SimplexSchedule(m, n, kind), RS.SimplexSchedule(m, n, kind)
        for k in (1, 2, 3, 4, 8):
            if k > ours.steps:
                continue
            for a, b in zip(TSS.shard_schedules(ours, k), RSS.shard_schedules(ref, k),
                            strict=True):
                assert a.ranges == b.ranges
                merged += k > 1 and len(a.ranges) == 1
                two += len(a.ranges) == 2
                assert np.array_equal(_emulated_table(a), b.table()), (m, n, kind, k, a.ranges)
    assert merged and two  # shards whose two ranges merged, and shards of two ranges


def test_unpack_reads_and_checks_the_launch_slots():
    h = TS.SimplexSchedule(2, 8, "hmap").device_descriptor("cpu").header  # 36 steps
    M = _unpack(h, None)
    assert (M["steps"], M["a0"], M["l0"], M["d1"]) == (36, 0, 36, -36)
    ok = h.copy()
    ok[SHARD_AT:] = [10, 0, 5, 31]  # the last range ends on the walk's last step
    assert _unpack(ok, None)["steps"] == 10
    assert np.array_equal(device_map(_unpack(ok, None), np.arange(10)),
                          np.asarray(RS.SimplexSchedule(2, 8, "hmap").table())[
                              np.r_[0:5, 31:36]])
    for slots in ([10, 0, 5, 32], [10, 32, 5, 0], [10, 0, 11, 0], [-1, 0, 0, 0],
                  [10, -1, 5, 0], [10, 0, -1, 0], [10, 0, 5, -1], [I32, 0, 0, 0]):
        bad = h.copy()
        bad[SHARD_AT:] = slots
        assert _unpack(bad, None) is None, slots
