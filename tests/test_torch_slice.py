"""The slice end to end: the port's public entry points
(repro_torch.kernels.ops) against the JAX package's (repro.kernels.ops)
on the same numpy inputs, plus the device policy: ``device=None``
without a card raises, and CPU tensors never touch a launch counter."""

import doctest

import types

import numpy as np
import pytest
import torch

import port_threads  # noqa: F401  (one torch thread a worker)

from repro.kernels import ops as R
from repro_torch import state as TSTATE
from repro_torch.kernels import _build, engine, ops, policy

RNG = np.random.default_rng(11)
X2 = (RNG.integers(0, 50, (16, 16))).astype(np.int32)
X3 = (RNG.integers(0, 50, (8, 8, 8))).astype(np.int32)
X4 = (RNG.integers(0, 50, (4, 4, 4, 4))).astype(np.int32)
S2 = (RNG.random((16, 16)) < 0.4).astype(np.int32)
S3 = (RNG.random((8, 8, 8)) < 0.35).astype(np.int32)
S4 = (RNG.random((4, 4, 4, 4)) < 0.35).astype(np.int32)
P = RNG.standard_normal((16, 3)).astype(np.float32)
P8 = RNG.standard_normal((8, 3)).astype(np.float32)

# (port entry, JAX entry, args, kwargs, exact)
ENTRIES = {
    "accum2d": (ops.simplex_accum2d, R.simplex_accum2d, (X2,), {"rho": 8, "kind": "hmap"}, True),
    "accum2d_rb": (ops.simplex_accum2d, R.simplex_accum2d, (X2,), {"rho": 4, "kind": "rb"}, True),
    "edm2d": (ops.simplex_edm2d, R.simplex_edm2d, (P,), {"rho": 4, "kind": "bb"}, False),
    "ca2d": (ops.simplex_ca2d, R.simplex_ca2d, (S2,), {"rho": 4, "kind": "hmap"}, True),
    "accum3d": (ops.simplex_accum3d, R.simplex_accum3d, (X3,), {"rho": 4, "kind": "octant"}, True),
    "accum3d_split": (ops.simplex_accum3d, R.simplex_accum3d, (X3[:6, :6, :6].copy(),),
                      {"rho": 2, "kind": "composite", "split": True}, True),
    "ca3d": (ops.simplex_ca3d, R.simplex_ca3d, (S3,), {"rho": 4, "kind": "table"}, True),
    "accum_md": (ops.simplex_accum_md, R.simplex_accum_md, (X4,), {"rho": 2, "kind": "hmap"}, True),
    "edm3d": (ops.simplex_edm3d, R.simplex_edm3d, (P8,), {"rho": 2, "kind": "composite"}, False),
    "edm_md": (ops.simplex_edm_md, R.simplex_edm_md, (P8[:4].copy(), 4),
               {"rho": 2, "kind": "bb"}, False),
    "ca_md": (ops.simplex_ca_md, R.simplex_ca_md, (S3,), {"rho": 2, "kind": "octant"}, True),
    # one m=4 CA step against the JAX engine (its 81-tile halo costs ~10 s)
    "ca_md_m4": (ops.simplex_ca_md, R.simplex_ca_md, (S4,), {"rho": 4, "kind": "bb"}, True),
}


@pytest.mark.parametrize("name", sorted(ENTRIES))
def test_entry_point_vs_jax(name):
    port_fn, jax_fn, args, kwargs, exact = ENTRIES[name]
    got = port_fn(*args, device="cpu", **kwargs)
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    want = np.asarray(jax_fn(*args, **kwargs))
    if exact:
        assert got.numpy().dtype == want.dtype
        assert np.array_equal(got.numpy(), want)
    else:  # float32 sums in another order: atol = rtol = 1e-5
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("m,nb,kind", [(2, 8, "hmap"), (2, 6, "composite"), (3, 4, "octant"),
                                       (4, 3, "composite")])
def test_map_table_vs_jax(m, nb, kind):
    got = ops.map_table(nb, kind=kind, m=m, device="cpu").numpy()
    assert np.array_equal(got, np.asarray(R.map_table(nb, kind=kind, m=m)))


def test_entry_points_accept_tensors_and_keep_input():
    x = torch.from_numpy(X2.copy())
    out = ops.simplex_accum2d(x, rho=4, device="cpu")
    assert torch.equal(x, torch.from_numpy(X2)) and out.data_ptr() != x.data_ptr()
    s = torch.from_numpy(S3.copy())
    ops.simplex_ca3d(s, rho=4, device="cpu")
    assert torch.equal(s, torch.from_numpy(S3))


CALLS = {
    "map_table": lambda **kw: ops.map_table(4, **kw),
    "accum2d": lambda **kw: ops.simplex_accum2d(X2, rho=4, **kw),
    "edm2d": lambda **kw: ops.simplex_edm2d(P, rho=4, **kw),
    "ca2d": lambda **kw: ops.simplex_ca2d(S2, rho=4, **kw),
    "accum3d": lambda **kw: ops.simplex_accum3d(X3, rho=4, **kw),
    "ca3d": lambda **kw: ops.simplex_ca3d(S3, rho=4, **kw),
    "accum_md": lambda **kw: ops.simplex_accum_md(X4, **kw),
    "edm3d": lambda **kw: ops.simplex_edm3d(P8, rho=2, **kw),
    "edm_md": lambda **kw: ops.simplex_edm_md(P8[:4].copy(), 4, rho=2, **kw),
    "ca_md": lambda **kw: ops.simplex_ca_md(S3, rho=2, **kw),
}


@pytest.mark.parametrize("name", sorted(CALLS))
def test_device_none_without_cuda_raises(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CALLS[name]()


def test_cpu_never_touches_launch_counters():
    for name in engine.registered_bodies():
        engine.get_body(name).launches = 0
    for call in CALLS.values():
        call(device="cpu")
    engine.accum_(torch.from_numpy(X3.copy()), rho=2)
    assert engine.launch_counts() == {"accum": 0, "ca": 0, "edm": 0, "map": 0}


def test_other_devices_are_refused():
    # meta tensors take the plain version (the dry run counts FLOPs on
    # them); a device with no kernel and no plain version is refused
    assert policy.on_card(torch.empty(1, device="meta"), "accum") is False
    for device in ("xpu", "mps"):
        with pytest.raises(ValueError, match="no kernel"):
            policy.on_card(types.SimpleNamespace(device=torch.device(device)), "accum")


def test_tile_contract():
    policy.check_tile("ca", 3, 16, 4, engine.CABody.smem_bytes(3, 4))
    with pytest.raises(ValueError, match="shared memory"):
        ops.simplex_edm2d(np.zeros((64, 8192), np.float32), rho=64, device="cpu")
    with pytest.raises(ValueError, match="must divide"):
        ops.simplex_ca2d(S2, rho=5, device="cpu")
    with pytest.raises(ValueError, match="outside"):
        policy.check_tile("accum", 9, 16, 2)


def test_build_needs_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build, "CUDA_HOME", tmp_path / "no-cuda")
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(_build, "_LIB", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.library()
    with pytest.raises(RuntimeError, match="cudaError 700"):
        _build.check(700, "accum")
    _build.check(0, "accum")


def test_build_root_is_in_the_checkout():
    repo = _build.CSRC.parents[3]
    assert _build.BUILD_ROOT == repo / "build" / "repro_torch"
    assert "build/" in (repo / ".gitignore").read_text().split()


def test_load_state_checks():
    st = TSTATE.load_state(3, domain=X3, points=P8, device="cpu")
    assert torch.equal(st.domain, torch.from_numpy(X3)) and st.points.dtype == torch.float32
    with pytest.raises(ValueError, match="m-cube"):
        TSTATE.load_state(3, domain=X2, device="cpu")
    with pytest.raises(ValueError, match="float"):
        TSTATE.load_state(2, points=X2, device="cpu")
    with pytest.raises(ValueError, match="int32"):
        TSTATE.load_state(2, table=np.zeros((10, 2), np.int64), nb=4, device="cpu")
    with pytest.raises(ValueError, match="nb"):
        TSTATE.load_state(2, table=np.zeros((10, 2), np.int32), device="cpu")
    with pytest.raises(ValueError, match=r"\[0, 4\)"):
        TSTATE.load_state(2, table=np.full((10, 2), 4, np.int32), nb=4, device="cpu")


@pytest.mark.parametrize("mod", [engine, ops, policy, TSTATE], ids=lambda m: m.__name__)
def test_port_kernel_doctests(mod):
    result = doctest.testmod(mod, verbose=False)
    assert result.failed == 0 and result.attempted > 0
