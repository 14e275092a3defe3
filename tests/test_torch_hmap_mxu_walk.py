"""The tensor-core map ``hmap2_coords_mxu`` on the card, held on the CPU.

``csrc/hmap_mxu.cu`` runs 8 warps a block and a warp per group of 128
blocks, in 16 FP64 ``mma.sync.m8n8k4`` products of 8 blocks each, with
the blocks as A's rows: lane ``l = 4r + k`` loads block ``r`` of the MMA
and holds ``A[r][k]``, its component ``k`` of ``(wx, wy, qb, 0)``, and
``B[k][r]`` of the map's constants ``rho * [[1, 0], [0, 1], [1, 2], [0,
0]]`` padded to 4 x 8; it gets ``D[r][2k]`` and ``D[r][2k + 1]``, so lane
``4r`` holds block ``r``'s ``(x, y)`` whole and stores it as one 8-byte
piece.  Every access is 8 bytes, so a ``(T, 2)`` view 8 bytes off a
16-byte boundary takes the same path; warps past the last group (``T /
128`` not a multiple of 8) do nothing.

Here, with numpy and no JAX call: the fragment maps (each element of A, B
and D held by one lane), an emulation of the walk (blocks, warps, groups,
every lane's load and store address, the product in float64 from the
lanes' fragments, the int64 conversion and the int32 wrap) bit-equal to
int64 arithmetic and to ``HMAP_MXU.plain`` at T = 128, a partial last
block, a view 8 bytes off, negative ``wx``, ``wy <= 0``, outputs above
2^24 and a rho whose outputs wrap; and the store pattern: the 8 storing
lanes of an MMA write 64 contiguous bytes, two whole 32-byte sectors.
"""

import re

import numpy as np
import pytest
import torch

import port_threads  # noqa: F401  (one torch thread a worker)

from repro_torch.kernels import _build
from repro_torch.kernels import hmap_mxu as TM

WARP, GROUP, MMAS = 32, 128, 16
LANES = np.arange(WARP)
ROW, K = LANES // 4, LANES % 4  # A's row and column of each lane


def _warps() -> int:
    """Warps a block, as ``hmap_mxu.cu`` defines them."""
    src = (_build.CSRC / "hmap_mxu.cu").read_text()
    return int(re.search(r"#define HMAP_MXU_WARPS (\d+)", src).group(1))


def _b_fragment(rho: int) -> np.ndarray:
    """Each lane's ``B[k][r]``: rho * [[1, 0], [0, 1], [1, 2], [0, 0]],
    columns 2-7 zero."""
    b = np.zeros((4, 8))
    b[:, 0] = [rho, 0, rho, 0]
    b[:, 1] = [0, rho, 2 * rho, 0]
    return b[K, ROW]


def _mma(a_frag: np.ndarray, b_frag: np.ndarray) -> np.ndarray:
    """``m8n8k4`` in float64 from the lanes' fragments: ``(..., 32)`` A
    and ``(32,)`` B in, ``(..., 32, 2)`` D out, lane ``l`` getting
    ``D[l / 4][2 (l % 4) + i]``."""
    a = np.zeros(a_frag.shape[:-1] + (8, 4))
    a[..., ROW, K] = a_frag
    b = np.zeros((4, 8))
    b[K, ROW] = b_frag
    d = a @ b
    return np.stack([d[..., ROW, 2 * K], d[..., ROW, 2 * K + 1]], -1)


def _wrap(v: np.ndarray) -> np.ndarray:
    """int64 -> int32 by wrap-around, as the kernel's casts and the plain
    version's ``.to(torch.int32)``."""
    return v.astype(np.int64).astype(np.int32)


def _pow2_floor(y: np.ndarray) -> np.ndarray:
    """``1 << (31 - clz(max(y, 1)))``: the exponent of ``frexp`` is exact
    for integers below 2^53."""
    e = np.frexp(np.maximum(y, 1).astype(np.float64))[1] - 1
    return np.left_shift(1, e).astype(y.dtype)


def _walk(mem: np.ndarray, lead: int, t: int, rho: int):
    """Emulate ``hmap2_coords_mxu_kernel`` over the int32 pairs at byte
    ``lead`` of ``mem``.  Returns the ``(T, 2)`` output and the byte
    offsets (from the output's start) each MMA's storing lanes write."""
    warps = _warps()
    groups = t // GROUP
    blocks = -(-groups // warps)
    out = np.full(2 * t, 0x5A5A5A5A, np.int32)  # poison: every pair must be written
    stores = []
    for bx in range(blocks):
        group = bx * warps + np.arange(warps)
        group = group[group < groups]  # warps past the last group return
        base = group[:, None] * GROUP + ROW  # (warps, 32): block r of the first MMA
        for j in range(MMAS):
            blk = base + 8 * j
            addr = lead + 8 * blk  # every lane's load: 8 bytes
            assert (addr % 8 == 0).all()
            wx, wy = mem[addr // 4], mem[addr // 4 + 1]
            bw = _pow2_floor(wy)
            qb = wx & ~(bw - 1)
            v = np.select([K == 0, K == 1, K == 2], [wx, wy, qb], 0)
            d = _mma(v.astype(np.float64), _b_fragment(rho))
            st = K == 0  # lane 4r: block r's (x, y) = D[r][0], D[r][1]
            sb = blk[:, st]
            out[2 * sb], out[2 * sb + 1] = _wrap(d[:, st, 0]), _wrap(d[:, st, 1])
            stores.append(8 * sb)
    return out.reshape(t, 2), stores


def _int64(wxy: np.ndarray, rho: int) -> np.ndarray:
    wx, wy = wxy[:, 0].astype(np.int64), wxy[:, 1].astype(np.int64)
    b = _pow2_floor(wy)
    qb = (wx // b) * b  # the floor division of the reference
    return _wrap(np.stack([rho * (wx + qb), rho * (wy + 2 * qb)], 1))


def _case(t: int, lead: int, wxs, wys, rho: int, seed: int):
    """``T`` random blocks laid ``lead`` bytes past a 16-byte boundary of
    an int32 buffer, every tenth ``wy`` at 0."""
    rng = np.random.default_rng(seed)
    wxy = np.stack([rng.integers(*wxs, t), rng.integers(*wys, t)], 1).astype(np.int32)
    wxy[::10, 1] = 0
    mem = np.zeros(2 * t + 8, np.int32)
    mem[lead // 4:lead // 4 + 2 * t] = wxy.ravel()
    return mem, wxy


CASES = {
    "T=128": (128, 0, (0, 1 << 12), (1, 1 << 12), 16),
    "partial last block": (128 * 13, 0, (0, 1 << 20), (1, 1 << 20), 16),
    "view 8 bytes off": (128 * 9, 8, (0, 1 << 20), (1, 1 << 20), 16),
    "negative wx, wy <= 0": (128 * 3, 0, (-(1 << 30), 1 << 30), (-64, 1 << 20), 1),
    "above 2^24": (128 * 2, 0, (1 << 24, 1 << 29), (0, 1 << 29), 1),
    "large rho, wrapped": (128 * 2, 8, (-(1 << 20), 1 << 20), (-8, 1 << 20), (1 << 17) + 3),
}


@pytest.mark.parametrize("name", list(CASES))
def test_walk_equals_int64_and_plain(name):
    t, lead, wxs, wys, rho = CASES[name]
    mem, wxy = _case(t, lead, wxs, wys, rho, seed=len(name))
    got, _ = _walk(mem, lead, t, rho)
    want = _int64(wxy, rho)
    assert np.array_equal(got, want)
    plain = TM.HMAP_MXU.plain(torch.from_numpy(wxy), rho).numpy()
    assert np.array_equal(got, plain)


def test_cases_reach_their_edges():
    assert (CASES["partial last block"][0] // GROUP) % _warps() != 0
    assert CASES["view 8 bytes off"][1] % 16 == 8
    _, wxy = _case(*CASES["above 2^24"], seed=len("above 2^24"))
    assert np.abs(_int64(wxy, 1)).max() > 1 << 24
    rho = CASES["large rho, wrapped"][-1]
    _, wxy = _case(*CASES["large rho, wrapped"], seed=len("large rho, wrapped"))
    assert np.abs(rho * wxy[:, 0].astype(np.int64)).max() > 2**31  # wraps in int32


def test_fragment_maps_cover_each_element_once():
    a = {(r, k) for r, k in zip(ROW, K)}
    b = {(k, r) for r, k in zip(ROW, K)}
    d = {(r, 2 * k + i) for r, k in zip(ROW, K) for i in (0, 1)}
    assert len(a) == 32 and len(b) == 32 and len(d) == 64
    # Columns 0 and 1 of D (x and y of block r) sit whole in lane 4r.
    xy = {4 * r + k for r, k in zip(ROW, K) if 2 * k < 2}
    assert xy == set(range(0, 32, 4))


def test_each_mma_stores_two_whole_sectors():
    t = 128 * 3
    mem, _ = _case(t, 0, (0, 1000), (1, 1000), 4, seed=0)
    _, stores = _walk(mem, 0, t, 4)
    assert sum(len(s) for s in stores) == (t // GROUP) * MMAS  # one row a warp and MMA
    for s in stores:
        for warp in s:  # one warp's 8 storing lanes, 8 bytes each
            assert sorted(warp) == list(range(warp.min(), warp.min() + 64, 8))
            assert warp.min() % 64 == 0


def test_wrapper_accepts_an_8_byte_off_view_on_the_cpu():
    store = torch.zeros(129, 2, dtype=torch.int32)
    store[1:, 0], store[1:, 1] = torch.arange(128), 5
    view = store[1:]
    assert view.data_ptr() % 16 == 8 and view.is_contiguous()
    got = TM.hmap2_coords_mxu(view, rho=2, device="cpu").numpy()
    assert np.array_equal(got, _int64(view.numpy(), 2))
