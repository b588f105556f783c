"""The port's native data library (gapartnet_tpu_torch/data/native_loader.py,
built from its own gapdata.cpp) against the JAX package's: fps_cpu,
instance_info and augment_points equal exactly between the two native
builds (the same source, compiler and flags); the plain NumPy versions
equal the native ones exactly for fps_cpu and for instance_info below
max_instances, and within 1e-6 for augment_points, whose products the
native build may contract into FMAs."""

import os
from pathlib import Path

import numpy as np
import pytest

from gapartnet_tpu.data import native_loader as jnl
from gapartnet_tpu_torch.data import native_loader as tnl

AUGMENT_TOL = 1e-6


@pytest.fixture(scope="module")
def jax_lib():
    lib = jnl.get_lib()
    assert lib is not None, "the JAX package's native library did not build"
    return lib


def _labelled(seed, n=600, num_instances=5):
    rng = np.random.RandomState(seed)
    pts = (rng.rand(n, 6) * 2 - 1).astype(np.float32)
    sem = rng.randint(0, 10, n).astype(np.int32)
    ins = rng.randint(-1, num_instances, n).astype(np.int32)
    ins[ins == -1] = -100
    return pts, sem, ins


def test_builds_its_own_library():
    lib = tnl.get_lib()
    path = tnl.library_path()
    assert path.exists() and lib._name == str(path)
    build_dir = Path(tnl.__file__).resolve().parent.parent / "_build"
    assert path.parent == build_dir and path.name.startswith("libgapdata-")
    assert tnl.SOURCE == Path(tnl.__file__).resolve().parent / "native" / "gapdata.cpp"
    assert Path(jnl._LIB_PATH).resolve() != path.resolve()
    assert tnl.build() == path      # built once, then reused


@pytest.mark.parametrize("seed,n,m", [(0, 300, 32), (1, 2000, 257), (2, 5, 5)])
def test_fps_cpu_equal(jax_lib, seed, n, m):
    pts = np.random.RandomState(seed).rand(n, 3).astype(np.float32)
    want = jnl.fps_cpu(pts, m)
    got = tnl.fps_cpu(pts, m)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tnl.fps_cpu(pts, m, native=False), want)


@pytest.mark.parametrize("seed,max_instances", [(0, 8), (1, 5), (2, 64)])
def test_instance_info_equal_below_the_cap(jax_lib, seed, max_instances):
    pts, sem, ins = _labelled(seed)
    want = jnl.instance_info(pts, sem, ins, max_instances)
    for native in (True, False):
        got = tnl.instance_info(pts, sem, ins, max_instances, native=native)
        assert got[3] == want[3] == 5
        for g, w in zip(got[:3], want[:3]):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)


def test_instance_info_past_the_cap(jax_lib):
    """7 instances, max_instances 3: both native builds leave the regions of
    instances 3..6 at 0; the plain version computes them."""
    pts, sem, ins = _labelled(3, num_instances=7)
    want = jnl.instance_info(pts, sem, ins, 3)
    got = tnl.instance_info(pts, sem, ins, 3)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got[3] == 3
    past = ins >= 3
    assert past.any() and (got[0][past] == 0).all() and (got[0][(ins >= 0) & ~past] != 0).any()
    plain = tnl.instance_info(pts, sem, ins, 3, native=False)
    assert plain[3] == 3 and (plain[0][past] != 0).all(axis=1).all()
    np.testing.assert_array_equal(plain[0][~past], got[0][~past])
    for g, p in zip(got[1:3], plain[1:3]):
        np.testing.assert_array_equal(g, p)


def test_instance_info_no_instances(jax_lib):
    pts, sem, _ = _labelled(4)
    ins = np.full(len(pts), -100, np.int32)
    want = jnl.instance_info(pts, sem, ins, 4)
    for native in (True, False):
        got = tnl.instance_info(pts, sem, ins, 4, native=native)
        assert got[3] == want[3] == 0
        for g, w in zip(got[:3], want[:3]):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("seed,c", [(0, 6), (1, 9), (2, 3)])
def test_augment_points_equal(jax_lib, seed, c):
    rng = np.random.RandomState(seed)
    pts = rng.rand(500, c).astype(np.float32)
    m = (np.eye(3) + rng.randn(3, 3) * 0.1).astype(np.float32)
    cd = (rng.randn(c - 3) * 0.3).astype(np.float32)
    want = jnl.augment_points(pts.copy(), m, cd)
    buf = pts.copy()
    got = tnl.augment_points(buf, m, cd)
    assert got is buf          # in place on a contiguous float32 array
    np.testing.assert_array_equal(got, want)
    plain = tnl.augment_points(pts.copy(), m, cd, native=False)
    np.testing.assert_allclose(plain, got, rtol=0, atol=AUGMENT_TOL)


def test_bad_shapes_raise():
    with pytest.raises(ValueError):
        tnl.fps_cpu(np.zeros((10, 6), np.float32), 3)
    with pytest.raises(ValueError):
        tnl.augment_points(np.zeros((10, 6), np.float32), np.eye(3), np.zeros(2))
    with pytest.raises(ValueError):
        tnl.instance_info(np.zeros((10, 6), np.float32), np.zeros(9, np.int32),
                          np.zeros(10, np.int32), 4)


def test_failed_build_raises(tmp_path):
    """No fallback: a missing compiler, or one that fails, raises with what
    it printed."""
    with pytest.raises(RuntimeError, match="cannot run"):
        tnl.build(cxx=str(tmp_path / "no-such-g++"), build_dir=tmp_path / "build")
    broken = tmp_path / "broken-g++"
    broken.write_text("#!/bin/sh\necho 'gapdata.cpp:1: error: no compiler here' >&2\nexit 1\n")
    os.chmod(broken, 0o755)
    with pytest.raises(RuntimeError, match="no compiler here"):
        tnl.build(cxx=str(broken), build_dir=tmp_path / "build")
    assert not list((tmp_path / "build").glob("*.so"))
