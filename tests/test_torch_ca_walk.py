"""Engine CA's walk on the card (``csrc/ca.cu``), emulated on the CPU.

The kernel runs one warp per schedule step (``CA_WARPS`` a block, fewer
where their halos would not fit a block's shared memory).  Each warp
stages its step's halo in its own slice of shared memory as rows along
the last axis, ``(rho+2)^(m-1)`` halo rows of ``RS = rho + 2L`` cells:
the left edge cell at ``L - 1``, the tile row's ``rho`` cells at ``L``,
the right edge at ``L + rho``.  On the 16-byte path (``L`` = the cells
of a piece) a lane loads whole pieces of a halo row and zeroes the cells
past the domain's edge, on the scalar path (``L = 1``) single cells; the
edge cells are scalars, wrapped mod n at m=2 (periodic) and 0 outside
``[0, n)`` at m >= 3 (free), masked by the domain of their own
position.  Then a lane takes a piece of the tile and sums, for each of
the ``3^(m-1)`` neighbour rows in the reference's order
(``itertools.product((-1, 0, 1), repeat=m)`` without the centre), the
left, middle and right cell in the state's own type, and writes the rule's
0/1 as a whole piece where the piece lies in the domain, else cell by
cell on it.

Here the emulation (the layout's stride, the piece size and the warps a
block taken out of the source) is held bit-equal to ``CABody.plain_`` at
m = 2, 3 and 4 in every CA dtype, on 0/1 states and on 16-bit and float32
states of other values, where the order of the adds shows (a reversed
order fails there); its halo's unused cells hold a sentinel the
emulation never reads.  ``CABody.smem_bytes`` is held to the kernel's
rule, and the plain version against the JAX package's engine once.
"""

import itertools
import pathlib
import re

import numpy as np
import pytest
import torch

import port_threads  # noqa: F401  (one torch thread a worker)

from repro.kernels import engine as E
from repro_torch.kernels import engine as TE
from repro_torch.kernels import policy

SRC = (pathlib.Path(TE.__file__).parent / "csrc" / "ca.cu").read_text()
CA_WARPS = int(re.search(r"#define CA_WARPS (\d+)", SRC).group(1))
CA_SMEM_LIMIT = int(re.search(r"#define CA_SMEM_LIMIT (\d+)", SRC).group(1))
ROW_STRIDE = eval("lambda rho, lead: " + re.search(  # noqa: S307 - the kernel's own formula
    r"int ca_row_stride\(int rho, int lead\) \{\s*return (.*?);", SRC).group(1))
WARP = 32


def _name(t):
    return str(t).split(".")[-1]


def test_source_constants_agree_with_the_host():
    """The host's mirror: warps a block, the block's shared memory, and
    the 16-byte piece of every CA dtype."""
    assert CA_WARPS == TE.CA_WARPS and CA_SMEM_LIMIT == policy.SMEM_LIMIT
    assert ROW_STRIDE(16, 4) == 24 and "ca_tile<M, T, (int)(16 / sizeof(T))>" in SRC
    for m, rho in ((2, 16), (3, 8), (4, 4), (5, 4), (6, 4)):
        for size in (1, 2, 4, 8):
            for vec in (False, True):
                w = TE.CABody.warp_bytes(m, rho, size, vec)
                lead = 16 // size if vec else 1
                assert w == -(-(rho + 2) ** (m - 1) * ROW_STRIDE(rho, lead) * size // 16) * 16
                warps = CA_WARPS
                while warps > 1 and w * warps > CA_SMEM_LIMIT:
                    warps -= 1
                assert TE.CABody.smem_bytes(m, rho, size, vec) == warps * w


# ---------------------------------------------------------------- the kernel's walk


def _digits(x: torch.Tensor, base: int, count: int) -> list:
    """The ``count`` digits of ``x`` in ``base``, most significant first
    (array axes 0..count-1, the last fastest)."""
    out = []
    for _ in range(count):
        out.insert(0, x % base)
        x = x // base
    return out


def _run(g: list, n: int) -> torch.Tensor:
    """Cells on the domain from ``g`` along the last axis (``ca_run``)."""
    return g[0] - g[1] + 1 if len(g) == 2 else n - sum(g)


def ca_emulation(out: torch.Tensor, inp: torch.Tensor, sched, rho: int, order=None) -> None:
    """``ca.cu``'s walk of one launch from ``inp`` into ``out``.

    Every valid step is one warp with its own halo slice (the unused lead
    cells hold a sentinel); ``order`` permutes the neighbour rows (the
    kernel's is ``range(3^(m-1))``) to show that the sum's order matters.
    """
    m, n = inp.ndim, inp.shape[0]
    size = inp.element_size()
    vec = (TE.CABody.vector_access(rho, size, inp.data_ptr(), out.data_ptr())
           and TE.CABody.warp_bytes(m, rho, size, True) <= CA_SMEM_LIMIT)
    pe = 16 // size if vec else 1
    lead, h = pe, rho + 2
    rs = ROW_STRIDE(rho, lead)
    vr = rho // pe
    hrows = h ** (m - 1)
    blocks = TE._valid_blocks(sched, inp.device)  # one warp each, array-axis order
    steps = len(blocks)
    src, dst = inp.reshape(-1), out.view(-1)
    zero = torch.zeros((), dtype=inp.dtype)
    sentinel = torch.tensor(77, dtype=inp.dtype)
    halo = sentinel.repeat(steps, hrows * rs)
    blk = [blocks[:, j, None] for j in range(m)]
    xb = blk[m - 1] * rho

    def halo_rows(hr):
        """Array coordinates of halo rows ``hr`` (axes 0..m-2) and whether
        each lies inside the free boundary."""
        g, ok = [], torch.ones(steps, len(hr), dtype=torch.bool)
        for j, d in enumerate(_digits(hr, h, m - 1)):
            v = blk[j] * rho - 1 + d[None]
            if m == 2:
                v = v % n
            else:
                ok = ok & (v >= 0) & (v < n)
            g.append(v)
        return g, ok

    def read(g, ok):
        """``inp`` at coordinates ``g`` where ``ok``, else 0."""
        idx = TE._offsets(torch.stack([x.clamp(0, n - 1) for x in g], -1), n)
        return torch.where(ok, src[idx], zero)

    # 1. the halo's tile-row pieces: lane e % 32 takes piece e = (row, k)
    e = torch.arange(hrows * vr)
    assert torch.equal(torch.sort(torch.cat([e[e % WARP == ln] for ln in range(WARP)]))[0], e)
    hr, k = e // vr, e % vr
    g, row_ok = halo_rows(hr)
    x0 = xb + k[None] * pe
    run = torch.where(row_ok, _run(g + [x0], n), 0)
    for i in range(pe):
        halo[:, hr * rs + lead + k * pe + i] = read(g + [x0 + i], row_ok & (i < run))
    # 2. the two edge cells of each halo row
    hr = torch.arange(hrows)
    g, ok = halo_rows(hr)
    for right in (0, 1):
        x = xb + rho if right else xb - 1
        x = x.expand(steps, hrows)
        if m == 2:
            x = x % n
            good = ok
        else:
            good = ok & (x >= 0) & (x < n)
        good = good & TE.domain_mask(m, n, g + [x])
        halo[:, hr * rs + (lead + rho if right else lead - 1)] = read(g + [x], good)
    # 3. the tile: lane e % 32 takes piece e = (tile row r, k)
    e = torch.arange(rho ** (m - 1) * vr)
    r, k = e // vr, e % vr
    ls = _digits(r, rho, m - 1)
    g = [blk[j] * rho + ls[j][None] for j in range(m - 1)]
    x0 = xb + k[None] * pe
    run = _run(g + [x0.expand_as(g[0])], n)
    centre = sum((ls[j] + 1) * h ** (m - 2 - j) for j in range(m - 1)) * rs + lead + k * pe
    rows = list(itertools.product((-1, 0, 1), repeat=m - 1))
    acc = [zero.repeat(steps, len(e)) for _ in range(pe)]
    for q in order if order is not None else range(len(rows)):
        off = sum(d * rs * h ** (m - 2 - j) for j, d in enumerate(rows[q]))
        cells = [halo[:, centre + off + c] for c in range(-1, pe + 1)]
        for i in range(pe):
            acc[i] = acc[i] + cells[i]
            if any(rows[q]):  # not the centre itself
                acc[i] = acc[i] + cells[i + 1]
            acc[i] = acc[i] + cells[i + 2]
    for i in range(pe):
        c = halo[:, centre + i]
        alive = ((c == 0) & (acc[i] == 3)) | ((c == 1) & ((acc[i] == 2) | (acc[i] == 3)))
        write = run > i  # a whole piece where run >= pe, else cell by cell
        idx = TE._offsets(torch.stack(g + [x0 + i], -1), n)
        dst[idx[write]] = alive[write].to(out.dtype)


def _state(m: int, n: int, dtype, values: str, seed: int) -> torch.Tensor:
    """A 0/1 state of density 0.4, or (``values='mixed'``) small counts
    with halves and signs beside +-256 and +-2048, where the order of
    16-bit adds shows (256 + 0.5 rounds back to 256 in bf16, 2048 + 0.5
    to 2048 in f16)."""
    rng = np.random.default_rng(seed)
    if values == "01":
        return torch.from_numpy((rng.random((n,) * m) < 0.4).astype(np.int64)).to(dtype)
    pick = np.array([0, 0, 1, 1, 1, 0.5, 1.5, 2, -1, 256, -256, 2048, -2048, 0.25])
    return torch.from_numpy(pick[rng.integers(0, len(pick), (n,) * m)]).to(dtype)


# (m, n, rho, kind): m=2 rho=16 is a whole number of pieces for every
# type; m=3 rho=4 for 4- and 8-byte types, m=4 rho=2 for 8-byte types;
# the rest take the scalar path.
CASES = [
    (2, 64, 16, "hmap"), (2, 64, 16, "bb"), (2, 96, 16, "composite"), (2, 48, 8, "rb"),
    (3, 32, 4, "hmap"), (3, 24, 4, "composite"), (3, 16, 8, "bb"),
    (4, 12, 2, "composite"), (4, 16, 4, "bb"),
]


@pytest.mark.parametrize("dtype", policy.CA_DTYPES, ids=_name)
@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_emulated_walk_is_bit_equal_to_plain(case, dtype):
    m, n, rho, kind = case
    values = "mixed" if dtype.is_floating_point else "01"
    inp = _state(m, n, dtype, values, seed=m * 100 + n)
    plan = TE.launch_plan(m, n // rho, kind, None, False)
    want, got = inp.clone(), inp.clone()
    for sched in plan:
        TE.get_body("ca").plain_(want, inp, sched, rho)
        ca_emulation(got, inp, sched, rho)
    assert torch.equal(got.view(-1).view(torch.uint8), want.view(-1).view(torch.uint8))
    assert not torch.equal(got, inp)


@pytest.mark.parametrize("dtype", (torch.bfloat16, torch.float16), ids=_name)
@pytest.mark.parametrize("m,n,rho", [(2, 64, 16), (3, 32, 4)])
def test_a_mixed_16bit_state_pins_the_order(m, n, rho, dtype):
    """On the mixed state the kernel's order is bit-equal to the plain
    version, and the same rows summed last to first are not: the state
    shows the order, so the card's bit-equal gate holds it."""
    inp = _state(m, n, dtype, "mixed", seed=7 + m)
    sched = TE.schedule_for(m, n // rho, "hmap")
    want = inp.clone()
    TE.get_body("ca").plain_(want, inp, sched, rho)
    got, wrong = inp.clone(), inp.clone()
    ca_emulation(got, inp, sched, rho)
    ca_emulation(wrong, inp, sched, rho, order=range(3 ** (m - 1) - 1, -1, -1))
    assert torch.equal(got, want)
    assert not torch.equal(wrong, want)


def test_misaligned_view_takes_the_scalar_path():
    m, n, rho = 2, 64, 16
    store = torch.zeros(n * n + 4, dtype=torch.int32)
    lead = (-store.data_ptr() % 16) // 4 + 1  # one element past a 16-byte boundary
    inp = store[lead:lead + n * n].view(n, n)
    inp.copy_(_state(m, n, torch.int32, "01", seed=3))
    out = inp.clone()
    assert not TE.CABody.vector_access(rho, 4, inp.data_ptr(), out.data_ptr())
    sched = TE.schedule_for(m, n // rho, "hmap")
    want = inp.clone()
    TE.get_body("ca").plain_(want, inp, sched, rho)
    ca_emulation(out, inp, sched, rho)
    assert torch.equal(out, want)


def test_plain_matches_jax_engine_on_a_mixed_state():
    m, n, rho = 2, 32, 8
    inp = _state(m, n, torch.float32, "mixed", seed=11)
    got = TE.ca(inp, rho=rho, kind="hmap", device="cpu")
    want = E.ca(inp.numpy(), rho=rho, kind="hmap", interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
