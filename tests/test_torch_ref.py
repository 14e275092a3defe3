"""The port's dense oracles (repro_torch.kernels.ref) against the JAX
package's (repro.kernels.ref), on the same numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import port_threads  # noqa: F401  (one torch thread a worker)

from repro.kernels import ref as R
from repro_torch.kernels import ref as TR

SIZES = [(2, 5), (2, 8), (3, 4), (3, 7), (4, 4), (4, 5)]


@pytest.mark.parametrize("m,n", SIZES)
def test_masks(m, n):
    assert np.array_equal(TR.simplex_mask(m, n).numpy(), np.asarray(R.simplex_mask(m, n)))
    if m == 2:
        assert np.array_equal(TR.tril_mask(n).numpy(), np.asarray(R.tril_mask(n)))
    if m == 3:
        assert np.array_equal(TR.tetra_mask(n).numpy(), np.asarray(R.tetra_mask(n)))


@pytest.mark.parametrize("m,n", SIZES)
@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_accum(m, n, dtype):
    x = (np.random.default_rng(n + m).integers(0, 50, (n,) * m)).astype(dtype)
    want = np.asarray(R.accum_md(jnp.asarray(x)))
    assert np.array_equal(TR.accum_md(torch.from_numpy(x)).numpy(), want)
    named = {2: (TR.accum2d, R.accum2d), 3: (TR.accum3d, R.accum3d)}.get(m)
    if named:
        assert np.array_equal(named[0](torch.from_numpy(x)).numpy(),
                              np.asarray(named[1](jnp.asarray(x))))


@pytest.mark.parametrize("m,n", SIZES)
def test_edm(m, n):
    # float32 tolerance: the two frameworks sum the squares in their own order
    p = np.random.default_rng(7 * n + m).standard_normal((n, 3)).astype(np.float32)
    got = TR.edm_md(torch.from_numpy(p), m).numpy()
    np.testing.assert_allclose(got, np.asarray(R.edm_md(jnp.asarray(p), m)),
                               rtol=1e-5, atol=1e-5)
    if m == 2:
        np.testing.assert_allclose(TR.edm2d(torch.from_numpy(p)).numpy(),
                                   np.asarray(R.edm2d(jnp.asarray(p))), rtol=1e-5, atol=1e-5)
    if m == 3:
        np.testing.assert_allclose(TR.edm3d(torch.from_numpy(p)).numpy(),
                                   np.asarray(R.edm3d(jnp.asarray(p))), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("m,n", SIZES + [(2, 12), (3, 9)])
def test_ca(m, n):
    s = (np.random.default_rng(3 * n + m).random((n,) * m) < 0.4).astype(np.int32)
    if m == 2:
        want = np.asarray(R.ca2d_step(jnp.asarray(s)))
        got = TR.ca2d_step(torch.from_numpy(s)).numpy()
    else:
        want = np.asarray(R.ca_md_step(jnp.asarray(s)))
        got = TR.ca_md_step(torch.from_numpy(s)).numpy()
        if m == 3:
            assert np.array_equal(TR.ca3d_step(torch.from_numpy(s)).numpy(),
                                  np.asarray(R.ca3d_step(jnp.asarray(s))))
    assert np.array_equal(got, want)


def test_ca_md_rejects_m2():
    with pytest.raises(ValueError):
        TR.ca_md_step(torch.zeros((4, 4), dtype=torch.int32))


@pytest.mark.parametrize("kind", ["hmap", "rb", "bb", "table", "composite"])
def test_map_table_2d(kind):
    nb = 8
    assert np.array_equal(TR.map_table_2d(nb, kind).numpy(), np.asarray(R.map_table_2d(nb, kind)))
