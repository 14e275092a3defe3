"""Causal flash attention on the 2-simplex grid (DESIGN.md §8).

The causal score matrix is a standard 2-simplex of tiles
``(q_tile, kv_tile)`` with ``kv <= q``.  The bounding-box schedule
(``kind='bb'``) visits all ``nq x nq`` tiles and skips the upper half,
the paper's BB baseline.  The folded schedule (``kind='folded'``) is the
zero-waste walk: pair ``p`` serves query tiles ``p`` and ``nq-1-p``::

    step j <= p:   (q, kv) = (p, j)
    step j >  p:   (q, kv) = (nq-1-p, j-p-1)

Every pair owns ``nq+1`` KV tiles, and each query tile's KV visits are
consecutive, which the online-softmax recurrence needs.  An odd tile
count self-pairs the middle tile: its second half-walk recomputes the
same output and rewrites it.

Two versions of the forward compute the same function:

* four CUDA kernels for CUDA tensors, each block walking one
  ``(b*Hq, pair)`` (folded) or ``(b*Hq, q tile)`` (bb) in order (the
  16-bit kernel below 64-row tiles several heads at once), chosen by a
  fixed rule (``flash_route``):

  - ``flash_wgmma`` (``kernels/csrc/flash_wgmma.cu``): float32 at
    ``block_q`` 64 and 128, 3xTF32 ``wgmma`` with every operand split
    once per block into shared memory;
  - ``flash`` (``kernels/csrc/flash_attention.cu``): float32 at
    ``block_q`` 8, 16 and 32, where a warpgroup's 64-row tile does not
    fit, 3xTF32 ``mma.sync``;
  - ``flash16_wgmma`` (``kernels/csrc/flash16_wgmma.cu``): bfloat16 and
    float16 at ``block_q`` 64 and 128, ``wgmma`` in the input type on
    Q, K and V in the 128-byte swizzle (V read MN-major), float32
    accumulators, P kept float32-accurate as two 16-bit parts;
  - ``flash16`` (``kernels/csrc/flash16_stacked.cu``): bfloat16 and
    float16 at ``block_q`` 8, 16 and 32, the same arithmetic on ``wgmma``
    with the query tiles of ``64 / block_q`` heads of a GQA group stacked
    in each warpgroup's 64 rows (``flash16_warpgroups`` warpgroups a
    block; a block per ``(b, KV head, head group, pair)``);

  all compute the reference's float32 softmax and round only the output
  to q's dtype;
* a plain PyTorch version that walks the same schedule over one batch of
  ``b*Hq`` slabs with the same running max, denominator, resets and
  flushes, for CPU tensors and as the kernels' reference on the card.

Dispatch follows the tensor; nothing falls back, and no kernel gives way
to another.  GQA reads the KV row ``bh // (Hq/Hkv)`` without a repeated
K/V tensor.  ``_reference_attention`` is the independent dense check.

Training: when q, k, v or the bias needs a gradient, the forward runs
inside ``FlashFunction``, the reference's custom VJP: the same kernel (or
plain version) forward on detached inputs, and a backward that sends the
cotangent through ``_reference_attention`` with torch autograd, torch ops
and no kernel, as the reference's backward is plain XLA.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _build
from .policy import SMEM_LIMIT, on_card, resolve_device

NEG_INF = -1e30

__all__ = [
    "NEG_INF",
    "FLASH",
    "FlashKernel",
    "FlashFunction",
    "flash_attention",
    "flash_fold_pairs",
    "flash_grid_steps",
    "folded_qkv",
    "kernel_fits",
    "flash_smem_bytes",
    "flash_route",
    "flash16_warpgroups",
    "launch_counts",
    "ROUTES",
]

# Tiles, head dims and dtypes the CUDA kernels are compiled for.
KERNEL_BLOCKS = (8, 16, 32, 64, 128)
KERNEL_HEAD_DIMS = (16, 32, 64, 128)
KERNEL_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
# The kernels, by the name their launch counter goes under.
ROUTES = ("flash", "flash16", "flash16_wgmma", "flash_wgmma")
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# Keys a chunk of flash_wgmma.cu (WG_BN) and of the 16-bit wgmma kernels
# (wgmma16.cuh F16_BN, F16_STAGES chunks in their ring).
_WG_BN = 32
_F16_BN, _F16_STAGES = 64, 3


def flash_fold_pairs(nq_tiles: int) -> int:
    """Folded-grid pair rows for ``nq_tiles`` query tiles.

    Example:
        >>> flash_fold_pairs(4), flash_fold_pairs(5)
        (2, 3)
    """
    if nq_tiles < 1:
        raise ValueError(f"nq_tiles must be >= 1, got {nq_tiles}")
    return (nq_tiles + 1) // 2


def flash_grid_steps(nq_tiles: int, kind: str) -> int:
    """Tile steps the schedule walks for ``nq_tiles`` query tiles, per
    ``b*Hq`` slab.

    Raises:
        ValueError: Unknown kind or non-positive tile count.

    Example:
        >>> flash_grid_steps(4, "bb"), flash_grid_steps(4, "folded")
        (16, 10)
        >>> flash_grid_steps(5, "folded")  # odd: 3 pair rows x 6 steps
        18
    """
    if nq_tiles < 1:
        raise ValueError(f"nq_tiles must be >= 1, got {nq_tiles}")
    if kind == "bb":
        return nq_tiles * nq_tiles
    if kind == "folded":
        return flash_fold_pairs(nq_tiles) * (nq_tiles + 1)
    raise ValueError(f"unknown flash schedule kind {kind!r}")


def folded_qkv(p: int, j: int, nq: int):
    """Folded step ``(p, j)`` -> ``(q_tile, kv_tile, is_start, is_last)``.

    Example:
        >>> [folded_qkv(0, j, 4)[:2] for j in range(5)]
        [(0, 0), (3, 0), (3, 1), (3, 2), (3, 3)]
    """
    second = j > p
    q = nq - 1 - p if second else p
    kv = j - p - 1 if second else j
    return q, kv, j in (0, p + 1), j in (p, nq)


def _schedule(kind: str, nq: int, p: int):
    """``(q, kv, start, last)`` of each live step of row ``p``, in order."""
    if kind == "folded":
        return [folded_qkv(p, j, nq) for j in range(nq + 1)]
    return [(p, kv, kv == 0, kv == p) for kv in range(p + 1)]


def _bias_index(bias_shape, b: int, hq: int):
    """Map from the fused ``bh`` index into the ``bias_b * bias_h`` slabs
    of a bias broadcast over batch and heads."""
    bias_b, bias_h = bias_shape[0], bias_shape[1]
    if bias_b not in (1, b) or bias_h not in (1, hq):
        raise ValueError(
            f"bias must broadcast over (batch={b}, heads={hq}); got "
            f"leading dims {(bias_b, bias_h)}"
        )

    def to_slab(bh):
        batch = bh // hq
        head = bh % hq
        bb = batch % bias_b if bias_b > 1 else 0 * batch
        hh = head % bias_h if bias_h > 1 else 0 * head
        return bb * bias_h + hh

    return to_slab


def flash_route(block_q: int, dtype=torch.float32) -> str:
    """The CUDA kernel that serves ``(block_q, dtype)``: a fixed rule.

    At ``block_q >= 64`` (a warpgroup's 64-row tile) float32 runs
    ``flash_wgmma`` and bfloat16 and float16 ``flash16_wgmma``; below it
    float32 runs ``flash`` (``mma.sync``) and the 16-bit types ``flash16``
    (``wgmma``, the heads of a GQA group stacked in a warpgroup).

    Example:
        >>> flash_route(128), flash_route(32)
        ('flash_wgmma', 'flash')
        >>> flash_route(64, torch.bfloat16), flash_route(32, torch.float16)
        ('flash16_wgmma', 'flash16')
    """
    wide = block_q >= 64
    if dtype in (torch.bfloat16, torch.float16):
        return "flash16_wgmma" if wide else "flash16"
    return "flash_wgmma" if wide else "flash"


def flash16_warpgroups(block_q: int, group: int) -> int:
    """Warpgroups a block of ``flash16`` (``csrc/flash16_stacked.cu``): a
    fixed rule.  A warpgroup stacks ``64 // block_q`` heads of a GQA
    group of ``group = Hq / Hkv`` heads; a second warpgroup is taken only
    when the group fills both.

    Example:
        >>> flash16_warpgroups(32, 8), flash16_warpgroups(16, 8), flash16_warpgroups(8, 8)
        (2, 2, 1)
        >>> flash16_warpgroups(32, 1)
        1
    """
    return 2 if group >= 2 * (64 // block_q) else 1


def flash_smem_bytes(block_q: int, d: int, dtype=torch.float32, warpgroups: int = 1) -> int:
    """Shared memory of one block of the kernel that serves ``(block_q,
    d, dtype)`` (``flash_route``).

    * ``flash_wgmma``: 1 KB of alignment slack, the big and small parts of
      the scaled Q tile and of a 32-key K chunk (rows of 128-byte atoms,
      ``ceil(d/32)`` atoms a row), the big and small parts of the chunk's
      V^T (``d`` rows of 128 bytes), the raw K and V chunk, the mbarrier.
      One block an SM at ``(128, 128)``.
    * ``flash``: the scaled Q rows of its warps (16 each, so
      ``max(block_q, 16)``) padded to ``d+4`` floats, then two K
      sub-chunks padded to ``d+4`` and two V sub-chunks padded to ``d+8``
      (the ``cp.async`` double buffer), ``min(16, block_q)`` keys each.
    * ``flash16_wgmma``: 1 KB of alignment slack, the Q tile and
      ``_F16_STAGES`` chunks of K and of V (``_F16_BN`` keys each), all in
      rows of 128-byte atoms, ``ceil(d/64)`` atoms a row.
    * ``flash16``: as ``flash16_wgmma`` with a Q stack of 64 rows a
      warpgroup (``warpgroups``, ``flash16_warpgroups``) in place of the Q
      tile.

    Example:
        >>> flash_smem_bytes(128, 128), flash_smem_bytes(32, 128)
        (230416, 51200)
        >>> flash_smem_bytes(128, 128, torch.bfloat16), flash_smem_bytes(32, 128, torch.float16)
        (132096, 115712)
        >>> flash_smem_bytes(8, 128, torch.bfloat16, warpgroups=2)
        132096
    """
    route = flash_route(block_q, dtype)
    bc = min(16, block_q)
    if route == "flash_wgmma":
        atoms = (d + 31) // 32
        return (1024 + 2 * atoms * 128 * (block_q + _WG_BN) + 2 * d * 128
                + 2 * _WG_BN * d * 4 + 16)
    if route in ("flash16_wgmma", "flash16"):
        atoms = (d + 63) // 64
        rows = block_q if route == "flash16_wgmma" else 64 * warpgroups
        return 1024 + atoms * 128 * (rows + 2 * _F16_STAGES * _F16_BN)
    return 4 * (max(block_q, 16) * (d + 4) + 2 * bc * (d + 4) + 2 * bc * (d + 8))


def kernel_fits(block_q: int, d: int, dtype=torch.float32) -> bool:
    """Whether a CUDA kernel is compiled for ``(block_q, d, dtype)`` and
    its block fits the shared memory a Hopper block may use (``flash16``
    at two warpgroups, its larger block)."""
    return (block_q in KERNEL_BLOCKS and d in KERNEL_HEAD_DIMS and dtype in KERNEL_DTYPES
            and flash_smem_bytes(block_q, d, dtype, warpgroups=2) <= SMEM_LIMIT)


class FlashKernel:
    """The flash forward's two versions and its launch counters.

    Attributes:
        launches: Launches of each CUDA kernel so far, by ``ROUTES`` name
            (``flash``, ``flash16``, ``flash16_wgmma``, ``flash_wgmma``),
            never of the plain version.
    """

    name = "flash"

    def __init__(self):
        self.launches = dict.fromkeys(ROUTES, 0)

    def plain(self, kind: str, block_q: int, scale: float, q, k, v, bias=None,
              seg=None) -> torch.Tensor:
        """The schedule walked with torch ops over all ``b*Hq`` slabs."""
        b, hq, s, d = q.shape
        hkv = k.shape[1]
        nq = s // block_q
        bh = b * hq
        dev = q.device
        slabs = torch.arange(bh, device=dev)
        kv_rows = slabs // (hq // hkv)
        qs = q.reshape(bh, nq, block_q, d).to(torch.float32) * scale
        kr = k.reshape(b * hkv, nq, block_q, d).to(torch.float32)
        vr = v.reshape(b * hkv, nq, block_q, d).to(torch.float32)
        if bias is not None:
            bias_slab = _bias_index(bias.shape, b, hq)(slabs)
            br = bias.reshape(-1, s, s).to(torch.float32)
        if seg is not None:
            segr = seg.reshape(b, nq, block_q)[slabs // hq]  # (bh, nq, bq)
        tri = torch.ones((block_q, block_q), dtype=torch.bool, device=dev).tril()
        full = torch.ones_like(tri)
        out = torch.empty((bh, nq, block_q, d), dtype=q.dtype, device=dev)
        rows = flash_fold_pairs(nq) if kind == "folded" else nq
        for p in range(rows):
            for qt, kt, start, last in _schedule(kind, nq, p):
                if start:
                    m = torch.full((bh, block_q), NEG_INF, device=dev)
                    l = torch.zeros((bh, block_q), device=dev)
                    acc = torch.zeros((bh, block_q, d), device=dev)
                kb = kr[kv_rows, kt]
                sc = qs[:, qt] @ kb.transpose(1, 2)  # (bh, bq, bq)
                if bias is not None:
                    sc = sc + br[bias_slab, qt * block_q:(qt + 1) * block_q,
                                 kt * block_q:(kt + 1) * block_q]
                valid = (tri if qt == kt else full)[None]
                if seg is not None:
                    valid = valid & (segr[:, qt, :, None] == segr[:, kt, None, :])
                sc = torch.where(valid, sc, NEG_INF)
                m_new = torch.maximum(m, sc.amax(-1))
                alpha = torch.exp(m - m_new)
                pr = torch.exp(sc - m_new[..., None]) * valid
                l = l * alpha + pr.sum(-1)
                acc = acc * alpha[..., None] + pr @ vr[kv_rows, kt]
                m = m_new
                if last:
                    out[:, qt] = (acc / torch.where(l == 0, 1.0, l)[..., None]).to(q.dtype)
        return out.reshape(b, hq, s, d)

    def kernel(self, kind: str, block_q: int, scale: float, q, k, v, bias=None,
               seg=None, warpgroups: Optional[int] = None) -> torch.Tensor:
        """The CUDA kernel ``flash_route(block_q, q.dtype)`` names, on CUDA
        tensors of one dtype in ``KERNEL_DTYPES``; the output is in that
        dtype.  ``warpgroups`` sets ``flash16``'s warpgroups a block (1
        or 2; None: ``flash16_warpgroups``); other routes take None."""
        b, hq, s, d = q.shape
        hkv = k.shape[1]
        route = flash_route(block_q, q.dtype)
        if warpgroups is None and route == "flash16":
            warpgroups = flash16_warpgroups(block_q, hq // hkv)
        bad = warpgroups not in (1, 2) if route == "flash16" else warpgroups is not None
        if bad:
            raise ValueError(f"flash kernel: warpgroups={warpgroups} for route {route}")
        for name, t in (("q", q), ("k", k), ("v", v)):
            if t.device.type != "cuda" or t.dtype not in KERNEL_DTYPES:
                raise ValueError(f"flash kernel takes float32, bfloat16 or float16 CUDA "
                                 f"tensors; {name} is {t.dtype} on {t.device}")
            if t.device != q.device or t.dtype != q.dtype:
                raise ValueError(f"flash kernel: {name} is {t.dtype} on {t.device}, q "
                                 f"{q.dtype} on {q.device}")
        if not kernel_fits(block_q, d, q.dtype):
            raise ValueError(
                f"flash kernel is built for block_q in {KERNEL_BLOCKS} and head_dim in "
                f"{KERNEL_HEAD_DIMS} within {SMEM_LIMIT} bytes of shared memory; got "
                f"block_q={block_q}, head_dim={d}"
            )
        q, k, v = (t.contiguous() for t in (q, k, v))
        # The copies move 16-byte pieces, and a view may start anywhere.
        q, k, v = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (q, k, v))
        bias_b = bias_h = 1
        if bias is not None:
            bias_b, bias_h = bias.shape[0], bias.shape[1]
            bias = bias.to(device=q.device, dtype=torch.float32).contiguous()
        if seg is not None:
            seg = seg.to(device=q.device, dtype=torch.int32).contiguous()
        out = torch.empty_like(q)
        args = [out.data_ptr(), q.data_ptr(), k.data_ptr(), v.data_ptr(),
                None if bias is None else bias.data_ptr(), bias_b, bias_h,
                None if seg is None else seg.data_ptr(), b, hq, hkv, s, d, block_q,
                int(kind == "folded"), float(scale)]
        lib = _build.library()
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream(q.device).cuda_stream
            if route == "flash_wgmma":
                code = lib.flash_wgmma_launch(*args, stream)
            elif route == "flash16_wgmma":
                code = lib.flash16_wgmma_launch(*args, _DTYPE_CODES[q.dtype], stream)
            elif route == "flash16":
                code = lib.flash16_stacked_launch(*args, _DTYPE_CODES[q.dtype], warpgroups,
                                                  stream)
            else:
                code = lib.flash_attention_launch(*args, stream)
        _build.check(code, route)
        self.launches[route] += 1
        return out


FLASH = FlashKernel()


def launch_counts() -> dict:
    """Launches of each flash kernel since its counter was last 0.

    Example:
        >>> sorted(launch_counts())
        ['flash', 'flash16', 'flash16_wgmma', 'flash_wgmma']
    """
    return dict(FLASH.launches)


def flash_attention(
    q,
    k,
    v,
    *,
    bias=None,
    segment_ids=None,
    kind: str = "folded",
    block_q: int = 128,
    block_kv: int = 128,
    scale: Optional[float] = None,
    device=None,
) -> torch.Tensor:
    """Causal self-attention on the simplex grid, GQA-aware.

    Args:
        q: Queries, ``(B, Hq, S, D)``.
        k: Keys, ``(B, Hkv, S, D)`` with ``Hq % Hkv == 0``.
        v: Values, same shape as ``k``.
        bias: Optional additive logit bias broadcastable to
            ``(B, Hq, S, S)``; its leading dims may each be 1.
        segment_ids: Optional ``(B, S)`` integer packing ids; attention
            only flows within equal ids.
        kind: ``'folded'`` (the simplex fold) or ``'bb'`` (bounding box).
        block_q: Query tile size (clamped to S; must divide S).
        block_kv: KV tile size; the fold pairs tiles 1:1, so it must
            equal ``block_q``.
        scale: Logit scale; defaults to ``1/sqrt(D)``.
        device: Where to run; None means the card.  Tensors already on
            it stay where they are.

    Returns:
        ``(B, Hq, S, D)`` attention output in ``q.dtype`` (float32
        softmax accumulation; on the card q, k and v are float32,
        bfloat16 or float16, all one dtype).

    Raises:
        ValueError: S not divisible by the block size, ``block_q !=
            block_kv``, a bias or segment ids of the wrong shape, or an
            unknown kind.
        RuntimeError: ``device`` is None and no CUDA device is present.

    Example:
        >>> q = torch.randn(1, 2, 8, 4)
        >>> out = flash_attention(q, q[:, :1], q[:, :1], block_q=4, block_kv=4,
        ...                       device="cpu")
        >>> bool(torch.allclose(out, _reference_attention(q, q[:, :1], q[:, :1],
        ...                                               None, None, 0.5), atol=1e-6))
        True
    """
    device = resolve_device(device)
    q, k, v = (torch.as_tensor(x, device=device) for x in (q, k, v))
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    if hkv < 1 or hq % hkv or tuple(k.shape) != (b, hkv, s, d) or k.shape != v.shape:
        raise ValueError(
            f"expected q (B, Hq, S, D) and k, v (B, Hkv, S, D) with Hq % Hkv == 0; "
            f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    block_q = min(block_q, s)
    block_kv = min(block_kv, s)
    if s % block_q or s % block_kv:
        raise ValueError(
            f"sequence length {s} must be divisible by the block size "
            f"(block_q={block_q}, block_kv={block_kv})"
        )
    if block_q != block_kv:
        raise ValueError(
            f"fold pairs q/kv tiles 1:1 (square tiles); got "
            f"block_q={block_q} != block_kv={block_kv}"
        )
    nq = s // block_q
    if scale is None:
        scale = 1.0 / (d**0.5)
    if kind == "folded" and nq == 1:
        kind = "bb"  # single tile: nothing to fold
    if kind not in ("folded", "bb"):
        raise ValueError(f"unknown flash schedule kind {kind!r}")
    if bias is not None:
        bias = torch.as_tensor(bias, device=device)
        if bias.ndim != 4:
            raise ValueError(f"bias must be 4-D, got shape {tuple(bias.shape)}")
        if tuple(bias.shape[2:]) != (s, s):
            raise ValueError(
                f"bias trailing dims must be ({s}, {s}), got {tuple(bias.shape)}"
            )
        _bias_index(bias.shape, b, hq)
    if segment_ids is not None:
        segment_ids = torch.as_tensor(segment_ids, device=device).to(torch.int32)
        if tuple(segment_ids.shape) != (b, s):
            raise ValueError(
                f"segment_ids must be (batch, seq) = ({b}, {s}), got "
                f"{tuple(segment_ids.shape)}"
            )
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in (q, k, v, bias)):
        return FlashFunction.apply(kind, block_q, float(scale), q, k, v, bias, segment_ids)
    return _flash_forward(kind, block_q, float(scale), q, k, v, bias, segment_ids)


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def _flash_forward(kind: str, block_q: int, scale: float, q: torch.Tensor, k: torch.Tensor,
                   v: torch.Tensor, bias: Optional[torch.Tensor],
                   seg: Optional[torch.Tensor]) -> torch.Tensor:
    """The CUDA kernel on the card, the plain version on the CPU.

    One dispatcher op, ``torch.ops.repro_torch.flash_attention``: a
    dispatch mode sees the forward as one op (its FLOP formula is
    registered in ``roofline/trace_cost.py``), and on ``meta`` tensors it
    gives its output's shape without a walk.
    """
    run = FLASH.kernel if on_card(q, "flash_attention") else FLASH.plain
    return run(kind, block_q, scale, q, k, v, bias, seg)


@_flash_forward.register_fake
def _flash_forward_shape(kind, block_q, scale, q, k, v, bias, seg) -> torch.Tensor:
    return torch.empty_like(q)


class FlashFunction(torch.autograd.Function):
    """The flash forward under autograd: the reference's ``_flash_core``
    custom VJP (JAX ``kernels/flash_attention.py``).

    The forward is ``_flash_forward`` on the inputs as they are (autograd
    records nothing inside it) and saves q, k, v, the bias and the segment
    ids.  The backward recomputes ``_reference_attention`` on them under
    ``torch.enable_grad()`` and returns its ``torch.autograd.grad`` for q,
    k, v and, when it needs one, the bias; integer segment ids get none.
    No kernel runs in the backward.

    Example:
        >>> q = torch.randn(1, 2, 8, 4, requires_grad=True)
        >>> out = flash_attention(q, q[:, :1], q[:, :1], block_q=4, block_kv=4,
        ...                       device="cpu")
        >>> out.grad_fn.name()
        'FlashFunctionBackward'
    """

    @staticmethod
    def forward(ctx, kind, block_q, scale, q, k, v, bias, seg):
        """The kernel (or plain version) forward; saves the residuals."""
        ctx.scale = scale
        ctx.save_for_backward(q, k, v, bias, seg)
        return _flash_forward(kind, block_q, scale, q, k, v, bias, seg)

    @staticmethod
    def backward(ctx, grad):
        """Cotangents through ``_reference_attention``."""
        q, k, v, bias, seg = ctx.saved_tensors
        want_bias = bias is not None and ctx.needs_input_grad[6]
        with torch.enable_grad():
            qd, kd, vd = (t.detach().requires_grad_(True) for t in (q, k, v))
            bd = bias.detach().requires_grad_(True) if want_bias else bias
            out = _reference_attention(qd, kd, vd, bd, seg, ctx.scale)
            wrt = (qd, kd, vd) + ((bd,) if want_bias else ())
            grads = torch.autograd.grad(out, wrt, grad)
        dq, dk, dv = (g if need else None for g, need in zip(grads, ctx.needs_input_grad[3:6]))
        return None, None, None, dq, dk, dv, (grads[3] if want_bias else None), None


def _reference_attention(q, k, v, bias, segment_ids, scale) -> torch.Tensor:
    """Dense causal attention: the full ``(B, Hq, S, S)`` scores (GQA heads
    repeated) with the kernel's NEG_INF causal and segment mask and
    additive bias; the independent check of both versions."""
    b, hq, s, d = q.shape
    g = hq // k.shape[1]
    kf = k.repeat_interleave(g, dim=1).to(torch.float32)
    vf = v.repeat_interleave(g, dim=1).to(torch.float32)
    sc = torch.einsum("bhid,bhjd->bhij", q.to(torch.float32) * scale, kf)
    if bias is not None:
        sc = sc + bias.to(torch.float32).expand(sc.shape)
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()[None, None]
    if segment_ids is not None:
        mask = mask & (segment_ids[:, None, :, None] == segment_ids[:, None, None, :])
    sc = torch.where(mask, sc, NEG_INF)
    pr = torch.softmax(sc, dim=-1)
    return torch.einsum("bhij,bhjd->bhid", pr, vf).to(q.dtype)
