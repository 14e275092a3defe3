"""Engine ACCUM's memory access on the card, held on the CPU.

``csrc/accum.cu`` runs one warp per schedule step and, where the host's
fixed rule ``engine.accum_vector_access(rho, itemsize, data_ptr)`` says
so, reads and writes whole 16-byte pieces of a tile row: a piece whose
first element lies off the domain is left alone, and in a piece on the
domain's edge the elements past it are written back unchanged.  Where
the rule says no (a tile row that is not a whole number of pieces, or an
array that does not start on a 16-byte boundary) each lane takes single
elements.

Here:

* the rule at every ACCUM dtype and ``rho`` in {1, 2, 4, 8, 16}, on an
  aligned tensor and on a misaligned view, against the smallest ``rho``
  that makes 16 bytes of each element size;
* an emulation of the kernel's walk (the warp's steps, each lane's
  pieces ``lane, lane + 32, ...`` with the tile's last axis fastest, the
  masked read-modify-write of 16 bytes through a byte view of the array)
  bit-equal to ``AccumBody.plain_`` at m = 2, 3 and 4 for hmap, bb and
  composite, fused and split, in every ACCUM dtype with each type's edge
  values (integers wrap, bfloat16 and float16 round), and on a
  misaligned view, where it takes the scalar path;
* the plain version against the JAX package's engine in interpret mode
  on one such case.
"""

import ml_dtypes
import numpy as np
import pytest
import torch

import port_threads  # noqa: F401  (one torch thread a worker)

from repro.kernels import engine as E
from repro_torch.kernels import engine as TE
from repro_torch.kernels import policy

NP = {torch.int8: np.int8, torch.uint8: np.uint8, torch.int16: np.int16,
      torch.int32: np.int32, torch.int64: np.int64, torch.bfloat16: ml_dtypes.bfloat16,
      torch.float16: np.float16, torch.float32: np.float32, torch.float64: np.float64}
# Values where +1 leaves the easy range: integers at their top (they
# wrap), floats where the sum rounds.
EDGES = {torch.int8: [127, 126, -128, -1], torch.uint8: [255, 254, 0, 1],
         torch.int16: [32767, 32766, -32768, -1], torch.int32: [2**31 - 1, -1, 7],
         torch.int64: [2**63 - 1, -1, 7], torch.bfloat16: [255, 256, 258, 260],
         torch.float16: [2047, 2048, 2050, 2051], torch.float32: [2.0**24 - 1, 2.0**24, 3.5],
         torch.float64: [2.0**53 - 1, 2.0**53, 0.25]}
# The least rho whose tile row is a whole number of 16-byte pieces.
MIN_VECTOR_RHO = {1: 16, 2: 8, 4: 4, 8: 2}
WARP = 32


def _name(t):
    return str(t).split(".")[-1]


def _input(m: int, n: int, dtype, seed: int) -> torch.Tensor:
    """Small values with the type's edges on every third element."""
    rng = np.random.default_rng(seed)
    flat = rng.integers(0, 100, n**m)
    pick = rng.integers(0, len(EDGES[dtype]), len(flat[::3]))
    if not dtype.is_floating_point:
        flat[::3] = np.asarray(EDGES[dtype], np.int64)[pick]
        return torch.from_numpy(flat.astype(NP[dtype]).reshape((n,) * m))
    flat = flat.astype(np.float64)
    flat[::3] = np.asarray(EDGES[dtype], np.float64)[pick]
    return torch.from_numpy(flat.reshape((n,) * m)).to(dtype)


# ---------------------------------------------------------------- the rule


@pytest.mark.parametrize("dtype", policy.ACCUM_DTYPES, ids=_name)
def test_vector_access_rule(dtype):
    size = torch.empty((), dtype=dtype).element_size()
    buf = torch.zeros(4096 + 16, dtype=dtype)
    aligned = buf[(-buf.data_ptr() % 16) // size:][:4096]
    misaligned = aligned.view(-1)[1:]
    assert aligned.data_ptr() % 16 == 0 and misaligned.data_ptr() % 16 != 0
    for rho in (1, 2, 4, 8, 16):
        want = rho >= MIN_VECTOR_RHO[size]
        assert TE.accum_vector_access(rho, size, aligned.data_ptr()) is want, (rho, size)
        assert TE.accum_vector_access(rho, size, misaligned.data_ptr()) is False, (rho, size)


# ---------------------------------------------------------------- the kernel's walk


def _run(g: torch.Tensor, n: int) -> torch.Tensor:
    """Elements on the domain from ``g`` along the last axis
    (``accum_run``): ``row - col + 1`` at m = 2, ``n - sum`` at m >= 3."""
    if g.shape[-1] == 2:
        return g[..., 0] - g[..., 1] + 1
    return n - g.sum(-1)


def _offsets(g: torch.Tensor, n: int) -> torch.Tensor:
    off = g[..., 0]
    for j in range(1, g.shape[-1]):
        off = off * n + g[..., j]
    return off


def accum_emulation(x: torch.Tensor, sched, rho: int) -> None:
    """``accum.cu``'s walk of one launch on ``x``, in place.

    Every valid step is one warp; its block coordinates (array-axis
    order) are what lane 0's map gives.  Vector path: piece ``e`` of the
    tile (lane ``e % 32`` takes it) is row ``e // vr`` (digits in base rho,
    the second-to-last axis fastest) and piece ``e % vr`` of that row, its
    first element at ``g``; if ``run(g) > 0`` the lane reads the 16 bytes
    at ``g``, adds one to the first ``run(g)`` elements in the array's
    type and writes all 16 back.  Scalar path: element ``e`` adds one
    where it lies on the domain.
    """
    m, n = x.ndim, x.shape[0]
    size = x.element_size()
    blocks = TE._valid_blocks(sched, x.device)  # one warp each
    flat = x.view(-1)
    if not TE.accum_vector_access(rho, size, x.data_ptr()):
        e = torch.arange(rho**m)
        digits = torch.stack([(e // rho**(m - 1 - j)) % rho for j in range(m)], -1)
        g = blocks[:, None, :] * rho + digits[None]
        on = TE.domain_mask(m, n, g.unbind(-1))
        off = _offsets(g, n)[on]
        flat[off] = flat[off] + 1
        return
    ev = 16 // size
    vr = rho // ev
    e = torch.arange(rho ** (m - 1) * vr)
    lanes = e % WARP
    assert torch.equal(torch.sort(torch.cat([e[lanes == ln] for ln in range(WARP)]))[0], e)
    row, piece = e // vr, e % vr
    digits = [piece * ev]
    for j in range(m - 2, -1, -1):
        digits.insert(0, row % rho)
        row = row // rho
    g = blocks[:, None, :] * rho + torch.stack(digits, -1)[None]
    run = _run(g, n).reshape(-1)
    start = _offsets(g, n).reshape(-1) * size  # byte offsets of the pieces
    start, run = start[run > 0], run[run > 0]
    assert bool(((x.data_ptr() + start) % 16 == 0).all())
    raw = flat.view(torch.uint8)
    at = start[:, None] + torch.arange(16)
    pieces = raw[at].contiguous().view(x.dtype)  # (pieces, ev) in the array's type
    keep = torch.arange(ev)[None] < run[:, None]
    raw[at] = torch.where(keep, pieces + 1, pieces).contiguous().view(torch.uint8)


# (m, n, rho, kind, split): m=2 rho=16 is 16 bytes for every type; m=3
# rho=4 for 4- and 8-byte types, m=4 rho=2 for 8-byte types, the rest on
# the scalar path.
CASES = [
    (2, 64, 16, "hmap", False), (2, 64, 16, "bb", False), (2, 96, 16, "composite", False),
    (2, 96, 16, "composite", True),
    (3, 32, 4, "hmap", False), (3, 32, 4, "bb", False), (3, 24, 4, "composite", False),
    (3, 24, 4, "composite", True),
    (4, 16, 2, "hmap", False), (4, 16, 2, "bb", False), (4, 12, 2, "composite", False),
    (4, 12, 2, "composite", True),
]


@pytest.mark.parametrize("dtype", policy.ACCUM_DTYPES, ids=_name)
@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_emulated_walk_is_bit_equal_to_plain(case, dtype):
    m, n, rho, kind, split = case
    x = _input(m, n, dtype, seed=m * 100 + n)
    plan = TE.launch_plan(m, n // rho, kind, split, True)
    assert len(plan) > 1 if split else len(plan) == 1
    want, got = x.clone(), x.clone()
    for sched in plan:
        TE.get_body("accum").plain_(want, sched, rho)
        accum_emulation(got, sched, rho)
    assert got.dtype == want.dtype == dtype
    assert torch.equal(got.view(-1).view(torch.uint8), want.view(-1).view(torch.uint8))
    assert not torch.equal(got, x)


@pytest.mark.parametrize("dtype", (torch.int8, torch.int32, torch.bfloat16, torch.float64),
                         ids=_name)
def test_misaligned_view_takes_the_scalar_path(dtype):
    m, n, rho = 2, 64, 16
    size = torch.empty((), dtype=dtype).element_size()
    store = torch.zeros(n * n + 16, dtype=dtype)
    lead = (-store.data_ptr() % 16) // size + 1  # one element past a 16-byte boundary
    x = store[lead:lead + n * n].view(n, n)
    x.copy_(_input(m, n, dtype, seed=5))
    assert x.is_contiguous() and not TE.accum_vector_access(rho, size, x.data_ptr())
    before = store.clone()
    sched = TE.schedule_for(m, n // rho, "hmap")
    want = x.clone()
    TE.get_body("accum").plain_(want, sched, rho)
    accum_emulation(x, sched, rho)
    assert torch.equal(x, want)
    assert torch.equal(store[:lead], before[:lead])
    assert torch.equal(store[lead + n * n:], before[lead + n * n:])


def test_plain_matches_jax_engine_at_an_edge_dtype():
    m, n, rho = 2, 64, 16
    x = _input(m, n, torch.int8, seed=9)
    got = TE.accum(x, rho=rho, kind="hmap", device="cpu")
    want = E.accum(x.numpy(), rho=rho, kind="hmap", interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
