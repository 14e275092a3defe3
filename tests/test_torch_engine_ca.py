"""The port's CA body on the CPU against the JAX engine (interpret
mode) and the JAX oracles: bit-equal on and off the domain.

The JAX CA launcher fetches 3^m shifted tiles per step, so its m >= 3
interpret calls are the slowest of the suite; this file keeps them to
the smallest sides that still cover every kind.
"""

import functools
import itertools

import numpy as np
import pytest

from repro.kernels import engine as E
from repro.kernels import ref as R
from repro_torch.kernels import engine as TE
import port_threads  # noqa: F401  (one torch thread a worker)

KINDS = {
    2: ["hmap", "rb", "bb", "table", "composite"],
    3: ["hmap", "octant", "bb", "table", "composite"],
    4: ["hmap", "bb", "table", "composite"],
}
ENGINE_CASES = (
    [(2, n, 4, k) for n in (16, 12) for k in KINDS[2]]
    + [(3, 8, 2, k) for k in KINDS[3] if k != "composite"] + [(3, 6, 2, "composite")]
    # m=4 against the JAX engine: tests/test_torch_slice.py (ca_md_m4)
)
WIDE_CASES = (
    [(2, n, rho, k) for n, rho in ((32, 4), (24, 4), (20, 4)) for k in KINDS[2]]
    + [(3, n, rho, k) for n, rho in ((16, 4), (12, 2), (10, 2)) for k in KINDS[3]]
    + [(4, n, rho, k) for n, rho in ((8, 2), (6, 2)) for k in KINDS[4]]
)


def _ids(case):
    return "m{}-n{}-rho{}-{}".format(*case)


def _state(m, n, masked=True):
    s = (np.random.default_rng(n * m + 1).random((n,) * m) < 0.4).astype(np.int32)
    return s * np.asarray(R.simplex_mask(m, n, np.int32)) if masked else s


@functools.lru_cache(maxsize=None)
def _oracle(m, n):
    """The unmasked state of side n and the JAX oracle's step of it,
    computed once per (m, n) for every kind that reuses them."""
    s = _state(m, n, masked=False)
    return s, np.asarray(R.ca2d_step(s) if m == 2 else R.ca_md_step(s))


@pytest.mark.parametrize("case", ENGINE_CASES, ids=_ids)
def test_ca_vs_jax_engine(case):
    m, n, rho, kind = case
    s = _state(m, n, masked=False)  # off-domain cells must keep their input
    got = TE.ca(s, rho=rho, kind=kind, device="cpu").numpy()
    assert np.array_equal(got, np.asarray(E.ca(s, rho=rho, kind=kind)))


@pytest.mark.parametrize("case", WIDE_CASES, ids=_ids)
def test_ca_vs_oracle(case):
    m, n, rho, kind = case
    s, want = _oracle(m, n)
    msk = np.asarray(R.simplex_mask(m, n)) == 1
    got = TE.ca(s, rho=rho, kind=kind, device="cpu").numpy()
    assert np.array_equal(got[msk], want[msk])
    assert np.array_equal(got[~msk], s[~msk])


def _involutions(m):
    for perm in itertools.permutations(range(m)):
        if perm != tuple(range(m)) and all(perm[perm[i]] == i for i in range(m)):
            yield perm


@pytest.mark.parametrize("m,n,rho", [(3, 8, 2), (4, 6, 2)])
def test_ca_axis_involution(m, n, rho):
    """The strict simplex and the 3^m stencil are symmetric under any
    axis permutation; a state symmetric under an involution stays so.
    (min(s, s^T) is symmetric only for an involution, so only those are
    drawn.)"""
    s = _state(m, n)
    for perm in _involutions(m):
        sym = np.minimum(s, s.transpose(perm))
        out = TE.ca_md(sym, rho=rho, kind="composite", device="cpu").numpy()
        assert np.array_equal(out, out.transpose(perm)), perm


def test_ca_kind_swap_consistency():
    s = _state(3, 8)
    outs = [TE.ca_md(s, rho=2, kind=k, device="cpu").numpy() for k in KINDS[3]]
    for o in outs[1:]:
        assert np.array_equal(outs[0], o)


def test_ca_split_request_launches_fused():
    """CA reads neighbouring tiles, so split=True must not cut a
    composite walk into pieces; the answer equals the fused launch."""
    from repro_torch.kernels.engine import get_body

    s = _state(3, 12)
    assert not get_body("ca").element_local
    fused = TE.SimplexKernel("ca", 3, rho=2, kind="composite", device="cpu")(s)
    split = TE.SimplexKernel("ca", 3, rho=2, kind="composite", split=True, device="cpu")(s)
    assert np.array_equal(fused.numpy(), split.numpy())
