"""The simplex entry points with their default arguments against the JAX
package's defaults, on the CPU.

Both packages default to ``kind='auto'`` and ``split=None``: each asks its
own autotuner, for its own device, which schedule to walk.  The
schedules may differ; the outputs may not: integers bit-equal, EDM within
``atol = rtol = 1e-5`` (float32 sums run in another order).  One JAX
engine call per entry point keeps the file small.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import port_threads  # noqa: F401  (one torch thread a worker)

from repro.kernels import ops as RO
from repro_torch.core.schedule import resolve_kind
from repro_torch.kernels import ops as TO


@pytest.fixture(autouse=True)
def env(tmp_path, monkeypatch):
    """Private caches and absent artifacts for both packages' tuners."""
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(tmp_path / "autotune.json"))
    monkeypatch.setenv("REPRO_TORCH_BENCH_ARTIFACT", str(tmp_path / "BENCH_torch.json"))
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "reference_autotune.json"))
    monkeypatch.setenv("REPRO_BENCH_ARTIFACT", str(tmp_path / "reference_absent.json"))
    for name in ("REPRO_TORCH_AUTOTUNE_DISABLE", "REPRO_TORCH_SPLIT_PIECES",
                 "REPRO_AUTOTUNE_DISABLE", "REPRO_SPLIT_PIECES"):
        monkeypatch.delenv(name, raising=False)


def _x(m, n):
    return (np.arange(n**m, dtype=np.int32).reshape((n,) * m) * 7) % 97


def _state(m, n):
    x = (np.arange(n**m).reshape((n,) * m) * 2654435761 % 7 < 3).astype(np.int32)
    idx = np.indices((n,) * m)
    return np.where(idx.sum(0) < n if m > 2 else idx[1] <= idx[0], x, 0).astype(np.int32)


def _points(n, d=3):
    return np.random.default_rng(n).standard_normal((n, d)).astype(np.float32)


# (name, port call, reference call, input, m, tile count): one size each,
# non-power-of-two tile counts at m >= 3 so 'auto' picks among the
# composite-era kinds.
CASES = [
    ("accum2d", lambda a: TO.simplex_accum2d(a, device="cpu"), RO.simplex_accum2d,
     _x(2, 32), 2, 4),
    ("ca2d", lambda a: TO.simplex_ca2d(a, device="cpu"), RO.simplex_ca2d,
     _state(2, 32), 2, 4),
    ("accum3d", lambda a: TO.simplex_accum3d(a, device="cpu"), RO.simplex_accum3d,
     _x(3, 24), 3, 6),
    ("accum_md", lambda a: TO.simplex_accum_md(a, device="cpu"), RO.simplex_accum_md,
     _x(4, 12), 4, 6),
]


@pytest.mark.parametrize("case", CASES, ids=lambda c: c[0])
def test_integer_defaults_bit_equal(case):
    name, port, reference, x, m, nb = case
    assert resolve_kind(m, nb, "auto", device="cpu") != "auto"
    got = port(x)
    want = np.asarray(reference(jnp.asarray(x)))
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want), name


@pytest.mark.parametrize("m,n", [(2, 32), (3, 24)])
def test_edm_defaults_within_tolerance(m, n):
    p = _points(n)
    if m == 2:
        got, want = TO.simplex_edm2d(p, device="cpu"), RO.simplex_edm2d(jnp.asarray(p))
    else:
        got = TO.simplex_edm_md(p, m, device="cpu")
        want = RO.simplex_edm_md(jnp.asarray(p), m)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
