"""The port's engine on the CPU (the kernels' plain PyTorch versions)
against the JAX engine in interpret mode and the JAX oracles.

Integers (MAP tables, ACCUM) are bit-equal; EDM is held to
atol = rtol = 1e-5 because float32 sums run in another order in the two
frameworks (the JAX engine itself misses its own oracle by <= 4.77e-7 at
m=2).  Sizes stay small: one interpret-mode JAX call takes 0.2-3 s.
"""

import numpy as np
import pytest
import torch

import port_threads  # noqa: F401  (one torch thread a worker)

from repro.core.schedule import SimplexSchedule, resolve_kind
from repro.kernels import engine as E
from repro.kernels import ref as R
from repro_torch.kernels import engine as TE

# (m, n, rho): a power-of-two and a non-power-of-two block count each.
SIZES = {2: [(16, 4), (12, 4)], 3: [(8, 2), (6, 2)], 4: [(8, 4), (6, 2)]}
KINDS = {
    2: ["hmap", "rb", "bb", "table", "composite"],
    3: ["hmap", "octant", "bb", "table", "composite"],
    4: ["hmap", "bb", "table", "composite"],
}
CASES = [(m, n, rho, k) for m, sizes in SIZES.items() for n, rho in sizes for k in KINDS[m]]
# the wider sweep against the dense oracles only
WIDE = {2: [(32, 4), (24, 4), (30, 6), (20, 4)], 3: [(16, 4), (12, 2), (10, 2)],
        4: [(8, 2), (6, 2), (10, 2)]}
WIDE_CASES = [(m, n, rho, k) for m, sizes in WIDE.items() for n, rho in sizes for k in KINDS[m]]


def _ids(case):
    return "m{}-n{}-rho{}-{}".format(*case)


def _x(m, n):
    return (np.arange(n**m, dtype=np.int32).reshape((n,) * m) * 7) % 97


def _points(m, n):
    return np.random.default_rng(10 * n + m).standard_normal((n, 3)).astype(np.float32)


@pytest.mark.parametrize("m,nb", [(2, 4), (2, 3), (2, 6), (3, 4), (3, 3), (4, 2), (4, 3)])
def test_map_vs_jax_engine(m, nb):
    for kind in KINDS[m]:
        got = TE.map_table(nb, m=m, kind=kind, device="cpu").numpy()
        assert got.dtype == np.int32
        assert np.array_equal(got, np.asarray(E.map_table(nb, m=m, kind=kind))), kind
        want = SimplexSchedule(m, nb, resolve_kind(m, nb, kind)).table()
        assert np.array_equal(got, want), kind


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_accum_vs_jax_engine(case):
    m, n, rho, kind = case
    x = _x(m, n)
    got = TE.accum(x, rho=rho, kind=kind, device="cpu")
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(E.accum(x, rho=rho, kind=kind)))


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_edm_vs_jax_engine(case):
    m, n, rho, kind = case
    p = _points(m, n)
    got = TE.edm(p, m, rho=rho, kind=kind, device="cpu").numpy()
    want = np.asarray(E.edm(p, m, rho=rho, kind=kind))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    off = np.asarray(R.simplex_mask(m, n)) == 0
    assert np.array_equal(got[off], np.zeros_like(got[off]))


@pytest.mark.parametrize("case", WIDE_CASES, ids=_ids)
def test_accum_edm_vs_oracles(case):
    m, n, rho, kind = case
    msk = np.asarray(R.simplex_mask(m, n)) == 1
    x = _x(m, n)
    got = TE.accum(x, rho=rho, kind=kind, device="cpu").numpy()
    assert np.array_equal(got[msk], np.asarray(R.accum_md(x))[msk])
    assert np.array_equal(got[~msk], x[~msk])
    p = _points(m, n)
    e = TE.edm(p, m, rho=rho, kind=kind, device="cpu").numpy()
    np.testing.assert_allclose(e, np.asarray(R.edm_md(p, m)), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("m", [2, 3, 4])
@pytest.mark.parametrize("dtype", [np.int64, np.float32, np.float64])
def test_accum_dtypes(m, dtype):
    n, rho = {2: (12, 4), 3: (8, 2), 4: (6, 2)}[m]
    x = _x(m, n).astype(dtype)
    got = TE.accum(x, rho=rho, kind="composite", device="cpu")
    assert got.dtype == torch.from_numpy(x).dtype
    msk = np.asarray(R.simplex_mask(m, n)) == 1
    assert np.array_equal(got.numpy()[msk], x[msk] + 1)
    assert np.array_equal(got.numpy()[~msk], x[~msk])


@pytest.mark.parametrize("m", [2, 3, 4])
def test_split_is_fused(m):
    n, rho = {2: (24, 4), 3: (12, 2), 4: (6, 2)}[m]
    x = _x(m, n)
    fused = TE.accum(x, rho=rho, kind="composite", device="cpu")
    split = TE.accum(x, rho=rho, kind="composite", split=True, device="cpu")
    assert torch.equal(fused, split)
    p = _points(m, n)
    assert torch.equal(TE.edm(p, m, rho=rho, kind="composite", device="cpu"),
                       TE.edm(p, m, rho=rho, kind="composite", split=True, device="cpu"))
    ref_split = np.asarray(E.accum(x, rho=rho, kind="composite", split=True))
    assert np.array_equal(split.numpy(), ref_split)


def test_accum_in_place():
    x = torch.from_numpy(_x(3, 8))
    want = TE.accum(x, rho=2, kind="octant", device="cpu")
    before = x.clone()
    out = TE.accum_(x, rho=2, kind="octant")
    assert out is x and torch.equal(x, want)
    functional = TE.accum(before, rho=2, kind="octant", device="cpu")
    assert torch.equal(functional, want) and not torch.equal(before, want)


def test_explicit_schedule():
    from repro_torch.core.schedule import SimplexSchedule as TSched

    sched = TSched(3, 4, "table")
    x = _x(3, 8)
    k = TE.SimplexKernel("accum", 3, rho=2, schedule=sched, device="cpu")
    assert torch.equal(k(x), TE.accum(x, rho=2, kind="table", device="cpu"))
    with pytest.raises(ValueError, match="explicit schedule"):
        TE.SimplexKernel("accum", 3, rho=4, schedule=sched, device="cpu")(x)
    mk = TE.SimplexKernel("map", 3, schedule=sched, device="cpu")
    assert np.array_equal(mk(4).numpy(), sched.table())


def test_argument_checks():
    with pytest.raises(ValueError, match="must divide"):
        TE.accum(_x(2, 10), rho=4, device="cpu")
    with pytest.raises(ValueError, match="m-cube"):
        TE.SimplexKernel("accum", 2, rho=2, device="cpu")(np.zeros((4, 6), np.int32))
    with pytest.raises(ValueError, match="edm_md serves"):
        TE.edm_md(np.zeros((8, 3), np.float32), 2, device="cpu")
    with pytest.raises(ValueError, match="ca_md serves"):
        TE.ca_md(np.zeros((8, 8), np.int32), device="cpu")
    with pytest.raises(ValueError, match="accum_md serves"):
        TE.accum_md(np.zeros((8, 8), np.int32), device="cpu")
    with pytest.raises(ValueError, match="m must be"):
        TE.SimplexKernel("accum", 1)
    with pytest.raises(ValueError, match="no kernel body"):
        TE.SimplexKernel("nope", 2)
    with pytest.raises(ValueError, match="unknown executor"):
        TE.SimplexKernel("accum", 2, executor="pallas")
    # executor='xla' serves MAP and ACCUM; EDM and CA raise, as in the reference.
    with pytest.raises(NotImplementedError, match="fused executor"):
        TE.SimplexKernel("edm", 2, rho=4, executor="xla", device="cpu")(np.zeros((8, 3)))
    with pytest.raises(NotImplementedError, match="fused executor"):
        TE.SimplexKernel("ca", 2, rho=4, executor="xla", device="cpu")(_x(2, 8))


def test_kernel_wrappers_check_operands():
    # The checks run before any build or launch, so they hold here without nvcc.
    s3 = TE.schedule_for(3, 4, "octant")
    good, p = torch.zeros((8,) * 3, dtype=torch.int32), torch.zeros((8, 5))
    TE.check_operand("accum", s3, 2, good)
    TE.check_operand("edm", s3, 2, good, points=p)
    bad = [
        (torch.zeros((8, 8), dtype=torch.int32), None),  # ndim != sched.m
        (torch.zeros((16,) * 3, dtype=torch.int32), None),  # side != nb * rho
        (torch.zeros((8, 8, 4), dtype=torch.int32), None),  # not a cube
        (good, torch.zeros((16, 5))),  # point rows != n
    ]
    for cube, pts in bad:
        with pytest.raises(ValueError, match="operand|points"):
            TE.check_operand("edm", s3, 2, cube, points=pts)
    before = TE.launch_counts()
    accum, edm, ca = (TE.get_body(b) for b in ("accum", "edm", "ca"))
    with pytest.raises(ValueError, match="operand"):
        accum.kernel_(bad[1][0], s3, 2)
    with pytest.raises(ValueError, match="points"):
        edm.kernel_(good.float(), torch.zeros((16, 5)), s3, 2)
    with pytest.raises(ValueError, match="operand"):
        ca.kernel_(bad[0][0].clone(), bad[0][0], s3, 2)
    with pytest.raises(ValueError, match="differ"):
        ca.kernel_(bad[1][0], good, s3, 2)
    with pytest.raises(ValueError, match="shared memory"):
        edm.kernel_(good.float(), torch.zeros((8, 1 << 16)), s3, 2)
    # Well-shaped CPU tensors are refused too: a wrapper launches or raises.
    with pytest.raises(ValueError, match="CUDA"):
        accum.kernel_(good, s3, 2)
    for piece in TE.schedule_for(3, 6, "composite").split_pieces():
        TE.check_operand("accum", piece, 2, torch.zeros((12,) * 3))
    assert TE.launch_counts() == before


def test_engine_surface():
    assert set(TE.registered_bodies()) == {"accum", "edm", "ca", "map"}
    assert TE.default_rho(2) == E.default_rho(2) and TE.default_rho(5) == E.default_rho(5)
    for m, nb, kind in [(2, 8, "hmap"), (2, 6, "hmap"), (3, 6, "octant"), (4, 8, "bb")]:
        assert TE.grid_steps(nb, kind, m) == E.grid_steps(nb, kind, m)
