"""Voxelization: the port against the JAX package on the same seeded clouds.

Integer outputs (keys, pc_voxel_id, num_voxels) must match exactly; mean
voxel features within 1e-5 (float32 sums in another order).  The JAX side
runs under jax.jit, as the model does: there XLA turns division by the
constant voxel size into multiplication by its float32 reciprocal, which
the port reproduces (ops/voxelize.div_const).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gapartnet_tpu.models.gapartnet import GAPartNetConfig as JaxConfig
from gapartnet_tpu.models.gapartnet import prepare_input_grid as jax_prepare
from gapartnet_tpu.ops import voxelize as jv
from gapartnet_tpu_torch.config import GAPartNetConfig
from gapartnet_tpu_torch.models.gapartnet import prepare_input_grid
from gapartnet_tpu_torch.ops import voxelize as tv

FEAT_TOL = 1e-5


def _clouds(seed, b=2, n=600, masked=50):
    rng = np.random.RandomState(seed)
    xyz = rng.randn(b, n, 3).astype(np.float32)
    xyz /= np.abs(xyz).max(axis=(1, 2), keepdims=True)
    rgb = rng.rand(b, n, 3).astype(np.float32)
    mask = np.ones((b, n), bool)
    mask[:, n - masked:] = False
    return np.concatenate([xyz, rgb], -1), mask


@pytest.mark.parametrize("seed,vsize", [(0, 0.01), (1, 0.05), (2, 0.013)])
def test_prepare_input_grid_matches(seed, vsize):
    pts, mask = _clouds(seed)
    kw = dict(voxel_size=(vsize,) * 3, max_points=pts.shape[1])
    jcfg, tcfg = JaxConfig(**kw), GAPartNetConfig(**kw)
    jk, jf, jn, jp = jax.jit(lambda p, m: jax_prepare(p, m, jcfg))(jnp.asarray(pts), jnp.asarray(mask))
    tk, tf, tn, tp = prepare_input_grid(torch.from_numpy(pts), torch.from_numpy(mask), tcfg)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=FEAT_TOL, atol=FEAT_TOL)
    # masked points have no voxel, and every valid point has one
    assert (tp.numpy()[~mask] == -1).all() and (tp.numpy()[mask] >= 0).all()


def test_voxelize_single_out_of_range_points():
    rng = np.random.RandomState(3)
    xyz = rng.rand(300, 3).astype(np.float32)
    feats = rng.rand(300, 4).astype(np.float32)
    rmin = np.array([0.1, 0.0, 0.0], np.float32)
    rmax = np.array([0.9, 1.0, 1.0], np.float32)
    vsize = (0.02, 0.03, 0.05)

    def jfn(x, f, lo, hi):
        return jv.voxelize_single(x, f, jnp.asarray(vsize, jnp.float32), lo, hi)

    jr = jax.jit(jfn)(xyz, feats, rmin, rmax)
    tr = tv.voxelize_single(torch.from_numpy(xyz), torch.from_numpy(feats), vsize,
                            torch.from_numpy(rmin), torch.from_numpy(rmax))
    np.testing.assert_array_equal(tr.voxel_keys.numpy(), np.asarray(jr.voxel_keys))
    np.testing.assert_array_equal(tr.pc_voxel_id.numpy(), np.asarray(jr.pc_voxel_id))
    assert int(tr.num_voxels) == int(jr.num_voxels)
    np.testing.assert_array_equal(tr.voxel_mask.numpy(), np.asarray(jr.voxel_mask))
    np.testing.assert_allclose(tr.voxel_features.numpy(), np.asarray(jr.voxel_features),
                               rtol=FEAT_TOL, atol=FEAT_TOL)
    assert (tr.pc_voxel_id.numpy()[(xyz[:, 0] < 0.1) | (xyz[:, 0] > 0.9)] == -1).all()


def test_pack_unpack_and_dedup_match():
    rng = np.random.RandomState(4)
    coords = rng.randint(0, 1024, (500, 3)).astype(np.int32)
    coords[250:] = coords[:250]   # duplicates
    valid = rng.rand(500) > 0.2
    jkeys = jv.pack_coords(jnp.asarray(coords))
    tkeys = tv.pack_coords(torch.from_numpy(coords))
    np.testing.assert_array_equal(tkeys.numpy(), np.asarray(jkeys))
    np.testing.assert_array_equal(tv.unpack_key(tkeys).numpy(), coords)
    ju, jid, jn = jv.dedup_keys(jkeys, jnp.asarray(valid))
    tu, tid, tn = tv.dedup_keys(tkeys, torch.from_numpy(valid))
    np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
    np.testing.assert_array_equal(tid.numpy(), np.asarray(jid))
    assert int(tn) == int(jn)
