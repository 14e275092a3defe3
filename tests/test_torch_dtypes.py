"""The element types the simplex kernels take on the card, held on the
CPU: the port's engine and its frozen originals (the kernels' plain
PyTorch versions) against the JAX package's engine and originals in
interpret mode, as the JAX package's own tests run them.

The reference's kernel bodies are dtype-generic: ACCUM adds 1 in the
array's own type (integers wrap, bfloat16 and float16 round to nearest
even), CA counts neighbours in the state's own type and casts its 0/1
result back, EDM computes in float32 and returns the points' type.  The
port's CUDA kernels take the same types (``policy.ACCUM_DTYPES``,
``CA_DTYPES``, ``EDM_DTYPES``; ``csrc/dtypes.cuh``), so the plain
versions they are held to on the card must agree with the reference in
every one of them.

ACCUM and CA are bit-equal; EDM is held to the existing atol = rtol =
1e-5, compared in float32 (float32 sums run in another order in the two
frameworks; at these sizes no distance lies within that of a 16-bit
rounding boundary, so both round to the same 16-bit value).  JAX runs
with 64-bit types off, so its int64 and float64 results come back as
int32 and float32 and its originals take 64-bit inputs as their 32-bit
values: the values are compared.  Inputs are made with numpy
from a seed.
"""

import ml_dtypes
import numpy as np
import pytest
import torch

import port_threads  # noqa: F401  (one torch thread a worker)

from repro.kernels import engine as E
from repro.kernels import legacy as JL
from repro_torch.kernels import engine as TE
from repro_torch.kernels import legacy as TL
from repro_torch.kernels import policy

NP = {torch.int8: np.int8, torch.uint8: np.uint8, torch.int16: np.int16,
      torch.int32: np.int32, torch.int64: np.int64, torch.bfloat16: ml_dtypes.bfloat16,
      torch.float16: np.float16, torch.float32: np.float32, torch.float64: np.float64}
NEW_ACCUM = (torch.int8, torch.uint8, torch.int16, torch.bfloat16, torch.float16)
NEW_CA = (torch.int8, torch.uint8, torch.int16, torch.int64, torch.bfloat16, torch.float16,
          torch.float32)
NEW_EDM = (torch.float16, torch.bfloat16, torch.float64)
# Values where +1 leaves the easy range: integers at their top (they
# wrap), bfloat16 around 256 and float16 around 2048 (the sum rounds).
EDGES = {torch.int8: [127, 126, -128, -1], torch.uint8: [255, 254, 0, 1],
         torch.int16: [32767, 32766, -32768, -1], torch.bfloat16: [255, 256, 258, 260],
         torch.float16: [2047, 2048, 2050, 2051]}


def _name(t):
    return str(t).split(".")[-1]


def _torch(a: np.ndarray, dtype) -> torch.Tensor:
    """The numpy input as a torch tensor of ``dtype``, element for element."""
    if dtype is torch.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a))


def _jax32(a: np.ndarray) -> np.ndarray:
    """The JAX originals cannot hold a 64-bit array with 64-bit types off
    (their in-place stores refuse the narrowed value): they take the same
    values in 32 bits."""
    return a.astype({np.dtype(np.int64): np.int32, np.dtype(np.float64): np.float32}
                    .get(a.dtype, a.dtype))


def _accum_input(m: int, n: int, dtype, seed: int) -> np.ndarray:
    """Values drawn from the type's edges and a small range; every edge
    lands on the domain (the first row or face is all domain)."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 100, (n,) * m).astype(np.float64)
    edge = np.asarray(EDGES[dtype], np.float64)
    flat = x.reshape(-1)
    flat[::3] = edge[rng.integers(0, len(edge), len(flat[::3]))]
    return x.astype(NP[dtype])


def _state(m: int, n: int, dtype, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (rng.random((n,) * m) < 0.4).astype(NP[dtype])


def _points(n: int, d: int, dtype, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((n, d)).astype(NP[dtype])


def _same(got: torch.Tensor, want, dtype) -> None:
    want = np.asarray(want)
    assert got.dtype == dtype
    assert got.shape == want.shape
    if dtype.is_floating_point:
        assert np.array_equal(got.float().numpy(), want.astype(np.float32))
    else:
        assert np.array_equal(got.numpy().astype(np.int64), want.astype(np.int64))


def test_card_dtype_tables():
    assert set(policy.ACCUM_DTYPES) == set(NP)
    assert set(policy.CA_DTYPES) == set(NP) - {torch.float64}
    assert set(policy.EDM_DTYPES) == {torch.float16, torch.bfloat16, torch.float32,
                                      torch.float64}
    assert sorted(policy.DTYPE_CODES.values()) == list(range(9))


@pytest.mark.parametrize("dtype", NEW_ACCUM, ids=_name)
def test_accum_edges_wrap_and_round_as_torch_does(dtype):
    """The plain version's +1 at the edges is torch's own ``x + 1``: int8
    127 -> -128, bf16 258 + 1 -> 260 and 260 + 1 -> 260 (ties to even)."""
    x = _torch(np.asarray(EDGES[dtype], np.float64).astype(NP[dtype]).reshape(2, 2), dtype)
    got = TE.accum(x, rho=1, kind="bb", device="cpu")
    assert torch.equal(got.tril(), (x + torch.ones((), dtype=dtype)).tril())
    assert torch.equal(got.triu(1), x.triu(1))
    if dtype is torch.int8:
        assert got[0, 0].item() == -128
    if dtype is torch.bfloat16:
        assert got.float().tolist() == [[256.0, 256.0], [260.0, 260.0]]


@pytest.mark.parametrize("dtype", NEW_ACCUM, ids=_name)
@pytest.mark.parametrize("m,n,rho,kind", [(2, 16, 4, "hmap"), (3, 8, 2, "octant"),
                                          (4, 8, 4, "hmap")])
def test_engine_accum_vs_jax(m, n, rho, kind, dtype):
    x = _accum_input(m, n, dtype, seed=m)
    got = TE.accum(_torch(x, dtype), rho=rho, kind=kind, device="cpu")
    _same(got, E.accum(x, rho=rho, kind=kind), dtype)


@pytest.mark.parametrize("dtype", NEW_ACCUM, ids=_name)
def test_legacy_accum_vs_jax(dtype):
    x2 = _accum_input(2, 16, dtype, seed=20)
    _same(TL.accum2d(_torch(x2, dtype), rho=4, device="cpu"), JL.accum2d(x2, rho=4), dtype)
    x3 = _accum_input(3, 8, dtype, seed=30)
    _same(TL.accum3d(_torch(x3, dtype), rho=2, device="cpu"), JL.accum3d(x3, rho=2), dtype)
    x4 = _accum_input(4, 4, dtype, seed=40)
    _same(TL.accum_md(_torch(x4, dtype), rho=2, device="cpu"), JL.accum_md(x4, rho=2), dtype)


# m=3 CA: an interpret-mode JAX call costs about 3 s whatever the size,
# so m=3 takes one integer type that wraps, int64 and bfloat16; the
# element arithmetic is the same at every m and m=2 takes every type.
CA_CASES = ([(2, 16, 4, "hmap", dt) for dt in NEW_CA]
            + [(3, 4, 2, "octant", dt) for dt in (torch.int8, torch.int64, torch.bfloat16)])


@pytest.mark.parametrize("m,n,rho,kind,dtype", CA_CASES,
                         ids=lambda v: _name(v) if isinstance(v, torch.dtype) else str(v))
def test_engine_ca_vs_jax(m, n, rho, kind, dtype):
    s = _state(m, n, dtype, seed=50 + m)
    got = TE.ca(_torch(s, dtype), rho=rho, kind=kind, device="cpu")
    _same(got, E.ca(s, rho=rho, kind=kind), dtype)


@pytest.mark.parametrize("dtype", NEW_CA, ids=_name)
def test_legacy_ca2d_vs_jax(dtype):
    s2 = _state(2, 16, dtype, seed=60)
    _same(TL.ca2d(_torch(s2, dtype), rho=4, device="cpu"), JL.ca2d(_jax32(s2), rho=4), dtype)


@pytest.mark.parametrize("dtype", [torch.int8, torch.int64, torch.bfloat16], ids=_name)
def test_legacy_ca3d_vs_jax(dtype):
    s3 = _state(3, 4, dtype, seed=61)
    _same(TL.ca3d(_torch(s3, dtype), rho=2, device="cpu"), JL.ca3d(_jax32(s3), rho=2), dtype)


@pytest.mark.parametrize("dtype", NEW_EDM, ids=_name)
@pytest.mark.parametrize("m,n,rho,kind", [(2, 16, 4, "hmap"), (3, 8, 2, "octant")])
def test_engine_edm_returns_the_points_dtype(m, n, rho, kind, dtype):
    p = _points(n, 5, dtype, seed=70 + m)
    got = TE.edm(_torch(p, dtype), m, rho=rho, kind=kind, device="cpu")
    assert got.dtype == dtype
    want = np.asarray(E.edm(p, m, rho=rho, kind=kind)).astype(np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", NEW_EDM, ids=_name)
def test_legacy_edm2d_returns_the_points_dtype(dtype):
    p = _points(16, 5, dtype, seed=80)
    got = TL.edm2d(_torch(p, dtype), rho=4, device="cpu")
    assert got.dtype == dtype
    want = np.asarray(JL.edm2d(_jax32(p), rho=4)).astype(np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=1e-5, atol=1e-5)
