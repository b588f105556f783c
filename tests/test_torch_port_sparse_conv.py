"""Sparse-conv geometry and the plain convs: the port against the JAX package.

Rulebooks (27, V), downsample maps and whole hierarchies must match
exactly, with and without a coordinate extent (including voxels outside
it).  The strided, inverse and pointwise convs match within 1e-5
(float32, sums in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gapartnet_tpu.ops import sparse_conv as js
from gapartnet_tpu.ops.voxelize import KEY_SENTINEL
from gapartnet_tpu_torch.ops import sparse_conv as ts

TOL = 1e-5


def _keys(seed, b=2, cap=400, active=(300, 250), grid=12):
    """(B, cap) sorted sentinel-padded keys of random active voxels."""
    rng = np.random.RandomState(seed)
    out = np.full((b, cap), KEY_SENTINEL, np.int32)
    allc = np.stack(np.meshgrid(*[np.arange(grid)] * 3, indexing="ij"), -1).reshape(-1, 3)
    for i in range(b):
        c = allc[rng.choice(len(allc), active[i], replace=False)] + 3
        k = np.sort((c[:, 0] << 20) | (c[:, 1] << 10) | c[:, 2])
        out[i, : len(k)] = k
    return out


def test_kernel_offsets_equal():
    for k in (2, 3):
        assert ts.kernel_offsets(k) == js.kernel_offsets(k)


@pytest.mark.parametrize("extent", [None, (20, 20, 20), (10, 14, 12)])
def test_subm_rulebook_matches(extent):
    keys = _keys(0)
    jn = jax.vmap(lambda k: js.build_subm_rulebook(k, 3, extent=extent))(jnp.asarray(keys))
    tn = ts.build_subm_rulebook(torch.from_numpy(keys), extent=extent)
    assert tn.dtype == torch.int32 and tuple(tn.shape) == (2, 27, 400)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    if extent == (10, 14, 12):
        # voxels beyond the extent exist, and lose links to them
        coords = np.stack([keys >> 20, (keys >> 10) & 1023, keys & 1023], -1)
        outside = (keys != KEY_SENTINEL) & (coords >= np.asarray(extent)).any(-1)
        assert outside.any()
        full = ts.build_subm_rulebook(torch.from_numpy(keys)).numpy()
        assert (full != tn.numpy()).any()


@pytest.mark.parametrize("out_cap", [400, 64])
def test_downsample_matches(out_cap):
    keys = _keys(1)
    jd = jax.vmap(lambda k: js.build_downsample(k, out_cap))(jnp.asarray(keys))
    td = ts.build_downsample(torch.from_numpy(keys), out_cap)
    for f in jd._fields:
        np.testing.assert_array_equal(getattr(td, f).numpy(), np.asarray(getattr(jd, f)), err_msg=f)
    if out_cap == 64:
        assert (td.num_dropped.numpy() > 0).all()


def test_hierarchy_matches():
    keys = _keys(2, cap=512, active=(500, 420), grid=14)
    nv = np.array([500, 420], np.int32)
    caps = [512, 200, 64]
    ext = (20, 20, 20)
    jh = js.build_hierarchy(jnp.asarray(keys), jnp.asarray(nv), caps, extent=ext)
    th = ts.build_hierarchy(torch.from_numpy(keys), torch.from_numpy(nv), caps, extent=ext)
    for jl, tl in zip(jh.levels, th.levels):
        for f in jl._fields:
            np.testing.assert_array_equal(getattr(tl, f).numpy(), np.asarray(getattr(jl, f)))
        np.testing.assert_array_equal(tl.voxel_mask.numpy(), np.asarray(jl.voxel_mask))
    for jd, td in zip(jh.downsamples, th.downsamples):
        for f in jd._fields:
            np.testing.assert_array_equal(getattr(td, f).numpy(), np.asarray(getattr(jd, f)))


def test_plain_convs_match():
    rng = np.random.RandomState(3)
    keys = _keys(3)
    cap_out = 200
    jd = jax.vmap(lambda k: js.build_downsample(k, cap_out))(jnp.asarray(keys))
    td = ts.build_downsample(torch.from_numpy(keys), cap_out)
    x = rng.randn(2, 400, 8).astype(np.float32)
    w8 = rng.randn(8, 8, 12).astype(np.float32)
    wup = rng.randn(8, 12, 8).astype(np.float32)
    w1 = rng.randn(8, 5).astype(np.float32)
    coarse = rng.randn(2, cap_out, 12).astype(np.float32)

    jdown = js.downsample_conv_apply(jnp.asarray(x), jd, jnp.asarray(w8), cap_out)
    tdown = ts.downsample_conv_apply(torch.from_numpy(x), td, torch.from_numpy(w8), cap_out)
    np.testing.assert_allclose(tdown.numpy(), np.asarray(jdown), rtol=TOL, atol=TOL)
    jup = js.inverse_conv_apply(jnp.asarray(coarse), jd, jnp.asarray(wup))
    tup = ts.inverse_conv_apply(torch.from_numpy(coarse), td, torch.from_numpy(wup))
    np.testing.assert_allclose(tup.numpy(), np.asarray(jup), rtol=TOL, atol=TOL)
    jlin = js.linear_conv_apply(jnp.asarray(x), jnp.asarray(w1))
    tlin = ts.linear_conv_apply(torch.from_numpy(x), torch.from_numpy(w1))
    np.testing.assert_allclose(tlin.numpy(), np.asarray(jlin), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("conv", ["down", "inverse", "linear"])
def test_plain_conv_gradients_match(conv):
    """Input and weight gradients against jax.vjp, through the dump-slot
    scatters: the coarse capacity of 64 drops voxels (child_parent = -1).
    rtol = atol = 1e-4 (each gradient sums over up to 400 rows)."""
    rng = np.random.RandomState(4)
    keys = _keys(4)
    cap_out = 64
    jd = jax.vmap(lambda k: js.build_downsample(k, cap_out))(jnp.asarray(keys))
    td = ts.build_downsample(torch.from_numpy(keys), cap_out)
    assert (td.child_parent.numpy() < 0).any()
    if conv == "down":
        x, w = rng.randn(2, 400, 8), rng.randn(8, 8, 12)
        jf = lambda a, b: js.downsample_conv_apply(a, jd, b, cap_out)
        tf = lambda a, b: ts.downsample_conv_apply(a, td, b, cap_out)
    elif conv == "inverse":
        x, w = rng.randn(2, cap_out, 12), rng.randn(8, 12, 8)
        jf = lambda a, b: js.inverse_conv_apply(a, jd, b)
        tf = lambda a, b: ts.inverse_conv_apply(a, td, b)
    else:
        x, w = rng.randn(2, 400, 8), rng.randn(8, 5)
        jf, tf = js.linear_conv_apply, ts.linear_conv_apply
    x, w = x.astype(np.float32), w.astype(np.float32)
    out, vjp = jax.vjp(jf, jnp.asarray(x), jnp.asarray(w))
    g = rng.randn(*out.shape).astype(np.float32)
    want_x, want_w = vjp(jnp.asarray(g))
    tx = torch.from_numpy(x).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    tf(tx, tw).backward(torch.from_numpy(g))
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want_x), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(want_w), rtol=1e-4, atol=1e-4)
