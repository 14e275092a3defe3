"""The 16-bit flash forward at 8-32-row tiles (``csrc/flash16_stacked.cu``),
its stacked rows and its grid emulated on the CPU.

A warpgroup's product is 64 rows tall, so the kernel stacks the same q
tile of ``64 / block_q`` query heads of one GQA group in a warpgroup's
rows (row ``r``: head slot ``r // block_q``, tile row ``r % block_q``),
takes ``warpgroups`` warpgroups a block, and launches one block per
``(batch, KV head, head group, pair row)``.  Slots past the group are
padding: zero Q, no bias, never stored.  Each q tile reads keys ``[0,
(qt + 1) block_q)`` in 64-key chunks; the chunk that reaches past the
tile is cut by the causal mask, and key rows past S land as zeros.

The formulas below are taken out of the kernel's source (the row map,
the block decomposition, the head of slot 0, the slots that hold a head,
the chunks of a q tile, the host's block count), so the emulation walks
what the kernel walks.  Held here:

* the grid covers every ``(batch, query head, pair row)`` exactly once
  for group in {1, 2, 4, 8}, ``block_q`` in {8, 16, 32} and one or two
  warpgroups;
* the emulated kernel (exact 16-bit products summed in float64, the
  online softmax in float32 over the 64-key chunks, P in two 16-bit
  parts) against the plain version within the 16-bit gate of
  ``test_torch_flash16`` at every head dim, folded and bb, with a bias
  of ``bias_h`` 1 or Hq and segment ids;
* a wrong head stride, or a padding row that is stored, fails that gate;
* one case against the JAX package's kernel in interpret mode.
"""

import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import port_threads  # noqa: F401  (one torch thread a worker)

from repro.kernels import flash_attention as RF
from repro_torch.kernels import flash_attention as TF
from test_torch_flash16 import _inputs, _segments, within_one_ulp

CSRC = pathlib.Path(TF.__file__).parent / "csrc"
SRC = (CSRC / "flash16_stacked.cu").read_text()
HEADER = (CSRC / "wgmma16.cuh").read_text()
DTYPES = (torch.bfloat16, torch.float16)


def _expr(pattern: str, src: str = SRC) -> str:
    """The C expression the pattern's group captures."""
    found = re.search(pattern, src)
    assert found, pattern
    return " ".join(found.group(1).split())


def _fn(args: str, expr: str):
    """A C integer expression over non-negative ints as a Python function:
    casts dropped, ``a.`` and ``St::`` members named plainly, ``/`` the
    integer division it is in C."""
    expr = re.sub(r"\((int|long long)\)", "", expr)
    expr = re.sub(r"\ba\.|St::", "", expr).replace("blockIdx.x", "bx").replace("/", "//")
    return eval(f"lambda {args}: {expr}")  # noqa: S307 - the kernel's own formula


BN = int(_expr(r"#define F16_BN (\d+)", HEADER))
SLOTS = _fn("BQ", _expr(r"int SLOTS = (.*?);"))                    # heads a warpgroup
HB = _fn("NWG, SLOTS", _expr(r"int HB = (.*?);"))                   # heads a block
SLOT = _fn("r, bq", _expr(r"int stack_slot\(int r, int bq\) \{ return (.*?); \}"))
TILE_ROW = _fn("r, bq", _expr(r"int stack_tile_row\(int r, int bq\) \{ return (.*?); \}"))
HEAD_GROUPS = _fn("group, hb",
                  _expr(r"int stack_head_groups\(int group, int hb\) \{\s*return (.*?);"))
CHUNKS = _fn("qt, bq, F16_BN",
             _expr(r"int stack_chunks\(int qt, int bq\) \{\s*return (.*?);"))
PAIR = _fn("bx, pairs", _expr(r"const int p = \(int\)\((.*?)\);"))
HEAD_GROUP = _fn("bx, pairs, hgs", _expr(r"const int hg = \(int\)\((.*?)\);"))
KV_ROW = _fn("bx, pairs, hgs", _expr(r"const long long kvrow = (.*?);"))
HEAD0 = _fn("kvrow, hkv, group, hg, HB", _expr(r"const int head0 = (.*?);"))
LIVE = _fn("HB, group, hg", "min(" + _expr(r"const int live = min\((.*?)\);") + ")")
BLOCKS = _fn("b, hkv, group, warpgroups, block_q, pairs",
             _expr(r"const long long blocks =\s*(.*?);").replace("stack_head_groups",
                                                                  "HEAD_GROUPS"))


def test_kernel_has_the_emulated_formulas():
    """Anchors: the formulas came out of the source and mean what the
    emulation says; the kernel reads its q tiles off flash_step and its
    keys through the zero-filling copy."""
    assert BN == 64 and [SLOTS(bq) for bq in (8, 16, 32)] == [8, 4, 2]
    assert HB(2, SLOTS(32)) == 4 and HEAD_GROUPS(8, 4) == 2 and HEAD_GROUPS(1, 2) == 1
    assert [(SLOT(r, 16), TILE_ROW(r, 16)) for r in (0, 15, 16, 63)] == [(0, 0), (0, 15), (1, 0),
                                                                        (3, 15)]
    assert CHUNKS(0, 8, BN) == 1 and CHUNKS(1, 32, BN) == 1 and CHUNKS(2, 32, BN) == 2
    assert LIVE(4, 2, 0) == 2 and LIVE(4, 8, 1) == 4
    assert "flash_step(a, p, 0, qt0" in SRC and "cp_async16_zfill" in SRC


# ---------------------------------------------------------------- the grid


def kernel_grid(b, hq, hkv, nq, block_q, kind, warpgroups):
    """``(batch, [head or None per slot], pair row)`` per block, in launch
    order, from the kernel's own decomposition."""
    group = hq // hkv
    hb = HB(warpgroups, SLOTS(block_q))
    hgs = HEAD_GROUPS(group, hb)
    pairs = TF.flash_fold_pairs(nq) if kind == "folded" else nq
    blocks = BLOCKS(b, hkv, group, warpgroups, block_q, pairs)
    out = []
    for bx in range(blocks):
        p, hg, kvrow = PAIR(bx, pairs), HEAD_GROUP(bx, pairs, hgs), KV_ROW(bx, pairs, hgs)
        head0, live = HEAD0(kvrow, hkv, group, hg, hb), LIVE(hb, group, hg)
        out.append((kvrow // hkv, [head0 + j if j < live else None for j in range(hb)], p))
    return out


@pytest.mark.parametrize("group", [1, 2, 4, 8])
@pytest.mark.parametrize("block_q", [8, 16, 32])
def test_grid_covers_every_head_and_pair_once(block_q, group):
    b, hkv, nq = 2, 3, 5
    hq = hkv * group
    for kind in ("folded", "bb"):
        pairs = TF.flash_fold_pairs(nq) if kind == "folded" else nq
        for w in (1, 2):
            grid = kernel_grid(b, hq, hkv, nq, block_q, kind, w)
            seen = [(bi, h, p) for bi, heads, p in grid for h in heads if h is not None]
            want = [(bi, h, p) for bi in range(b) for h in range(hq) for p in range(pairs)]
            assert sorted(seen) == want  # each exactly once
            for bi, heads, _ in grid:  # a block's heads share one KV head
                assert len({h // group for h in heads if h is not None}) == 1
            pad = sum(h is None for _, heads, _ in grid for h in heads)
            assert pad == len(grid) * HB(w, SLOTS(block_q)) - b * hq * pairs


def test_warpgroup_rule_fills_both_warpgroups():
    for bq in (8, 16, 32):
        for group in (1, 2, 4, 8, 16):
            w = TF.flash16_warpgroups(bq, group)
            assert w in (1, 2) and (w == 1 or group >= HB(2, SLOTS(bq)))
    assert TF.flash_smem_bytes(32, 128, torch.bfloat16, warpgroups=2) <= TF.SMEM_LIMIT


# ---------------------------------------------------------------- the kernel's walk


def stacked_emulation(q, k, v, block_q, scale, bias=None, seg=None, kind="folded",
                      warpgroups=1, head_stride=1, store_padding=False):
    """The kernel's blocks, run last to first (blocks run in no order, so
    a stray store lands after the right one): per q tile of the pair row,
    the stack of Q (row r: head ``head0 + head_stride * slot``, query
    ``qt * block_q + tile row``; padding slots zero), then 64-key chunks of
    K and V (zero past S): S from exact 16-bit products, scale, the
    row's bias slab by its head, causal (key <= query) and segment masks,
    the online softmax in float32, O += lo V + hi V; the rows of live
    slots (all rows with ``store_padding``) stored, rounded once."""
    dtype = q.dtype
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    group = hq // hkv
    nq = s // block_q
    hb = HB(warpgroups, SLOTS(block_q))
    out = torch.zeros((b * hq + 2 * hb, s, d), dtype=dtype)  # room for stray stores
    rows = torch.arange(64 * warpgroups)
    slot, trow = SLOT(rows, block_q), TILE_ROW(rows, block_q)
    grid = kernel_grid(b, hq, hkv, nq, block_q, kind, warpgroups)
    pad = lambda x: torch.cat([x, torch.zeros((BN,) + x.shape[1:], dtype=x.dtype)])  # noqa: E731
    for bi, heads, p in reversed(grid):
        head0 = heads[0]
        live = slot < sum(h is not None for h in heads)
        head = head0 + head_stride * slot
        kvh = head0 // group
        kk, vv = pad(k[bi, kvh]), pad(v[bi, kvh])
        tiles = [TF.folded_qkv(p, j, nq)[0] for j in (0, nq)] if kind == "folded" else [p]
        for qt in tiles:
            qpos = qt * block_q + trow
            qs = torch.zeros((len(rows), d), dtype=dtype)
            qs[live] = q[bi, head[live].clamp(max=hq - 1), qpos[live]]
            m = torch.full((len(rows),), TF.NEG_INF)
            l = torch.zeros(len(rows))
            acc = torch.zeros((len(rows), d), dtype=torch.float64)
            for c in range(CHUNKS(qt, block_q, BN)):
                keys = torch.arange(c * BN, (c + 1) * BN)
                kc, vc = kk[keys], vv[keys]
                sc = (qs.double() @ kc.double().T).to(torch.float32) * scale
                ok = keys[None, :] <= qpos[:, None]
                if seg is not None:
                    ok = ok & (seg[bi, qpos][:, None] == seg[bi, keys.clamp(max=s - 1)][None, :])
                if bias is not None:
                    hh = head % bias.shape[1] if bias.shape[1] > 1 else torch.zeros_like(head)
                    bslab = bias[bi % bias.shape[0]][hh.clamp(max=bias.shape[1] - 1)]
                    brow = bslab[torch.arange(len(rows)), qpos][:, keys.clamp(max=s - 1)]
                    sc = sc + torch.where(live[:, None], brow, 0.0)
                sc = torch.where(ok, sc, TF.NEG_INF)
                mn = torch.maximum(m, sc.amax(1))
                alpha = torch.exp(m - mn)
                pr = torch.where(ok, torch.exp(sc - mn[:, None]), 0.0)
                l = l * alpha + pr.sum(1)
                m = mn
                hi = pr.to(dtype)
                lo = (pr - hi.to(torch.float32)).to(dtype)
                acc = acc * alpha[:, None].double() + lo.double() @ vc.double() \
                    + hi.double() @ vc.double()
            res = (acc.to(torch.float32) / torch.where(l == 0, 1.0, l)[:, None]).to(dtype)
            keep = torch.ones_like(live) if store_padding else live
            out[bi * hq + head[keep], qpos[keep]] = res[keep]
    return out[:b * hq].reshape(b, hq, s, d)


# (block_q, hq, hkv, kind, bias heads (None: no bias), segments, warpgroups, s)
EMULATED = [
    (32, 4, 2, "folded", None, False, 1, 160),
    (32, 8, 2, "folded", "hq", True, 2, 96),
    (16, 8, 2, "bb", "hq", False, 1, 144),
    (16, 2, 2, "folded", None, True, 1, 80),   # Hq == Hkv: three padding slots of four
    (8, 4, 1, "folded", 1, True, 1, 136),
]


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda t: str(t).split(".")[-1])
@pytest.mark.parametrize("d", TF.KERNEL_HEAD_DIMS)
@pytest.mark.parametrize("case", EMULATED, ids=lambda c: "-".join(map(str, c)))
def test_emulated_kernel_within_the_gate_of_plain(case, d, dtype):
    block_q, hq, hkv, kind, bias_h, with_seg, w, s = case
    b = 2
    _, (q, k, v) = _inputs(b, hq, hkv, s, d, dtype, seed=block_q + d + hq)
    bias = None
    if bias_h is not None:
        lead = (1, hq) if bias_h == "hq" else (b, 1)
        bias = torch.from_numpy(np.random.default_rng(d).standard_normal(
            lead + (s, s)).astype(np.float32))
    seg = torch.from_numpy(_segments(b, s)) if with_seg else None
    scale = d**-0.5
    got = stacked_emulation(q, k, v, block_q, scale, bias, seg, kind, w)
    want = TF.FLASH.plain(kind, block_q, scale, q, k, v, bias, seg)
    assert got.dtype == want.dtype == dtype
    within_one_ulp(got, want, dtype, v.abs().max().item())


@pytest.mark.parametrize("fault", ["head stride", "padding stored"])
def test_a_wrong_layout_fails_the_gate(fault):
    """A slot's head at stride 2 (group 4, two slots a warpgroup), or the
    padding slot of Hq == Hkv stored (onto the next KV head's query head),
    moves the output far beyond the gate."""
    d, block_q = 32, 32
    hq, hkv = (4, 1) if fault == "head stride" else (2, 2)
    _, (q, k, v) = _inputs(1, hq, hkv, 96, d, torch.bfloat16, seed=5)
    want = TF.FLASH.plain("folded", block_q, d**-0.5, q, k, v)
    kw = {"head_stride": 2} if fault == "head stride" else {"store_padding": True}
    got = stacked_emulation(q, k, v, block_q, d**-0.5, **kw)
    assert (got.float() - want.float()).abs().max().item() > 0.1
    within_one_ulp(stacked_emulation(q, k, v, block_q, d**-0.5), want, torch.bfloat16,
                   v.abs().max().item())


def test_emulated_kernel_matches_jax_at_32_row_tiles():
    """The emulated kernel against the JAX package's kernel in interpret
    mode at 32-row bf16 tiles and Hq / Hkv = 2."""
    (qn, kn, vn), (q, k, v) = _inputs(1, 4, 2, 96, 32, torch.bfloat16, seed=9)
    got = stacked_emulation(q, k, v, 32, 32**-0.5)
    want = RF.flash_attention(jnp.asarray(qn), jnp.asarray(kn), jnp.asarray(vn), block_q=32,
                              block_kv=32, interpret=True)
    within_one_ulp(got, torch.from_numpy(np.asarray(want).astype(np.float32)), torch.bfloat16,
                   v.abs().max().item())
