"""ops/umeyama.py and ops/cpd.py of the port against the JAX package's, and
both branches of estimate_joint_angle.

The RANSAC fit is fed the JAX package's own jax.random.choice draws (the
port separates the draw from the fit): boxes, scales, rotations and
translations within 1e-4, inlier masks and ok flags equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from gapartnet_tpu.infer.api import estimate_joint_angle as jax_joint
from gapartnet_tpu.ops.cpd import rigid_cpd as jax_cpd
from gapartnet_tpu.ops.umeyama import ransac_pose_from_npcs as jax_ransac
from gapartnet_tpu.ops.umeyama import umeyama_masked as jax_umeyama
from gapartnet_tpu_torch.infer.api import estimate_joint_angle
from gapartnet_tpu_torch.ops.cpd import rigid_cpd
from gapartnet_tpu_torch.ops.umeyama import ransac_pose_from_npcs, ransac_samples, umeyama_masked
from tests.test_torch_port_infer import jax_draws

TOL = 1e-4


def _similar(rng, m, noise=0.002, outliers=0.0):
    """(npcs, xyz): xyz = s * npcs @ R + t plus noise, a share of rows
    replaced by outliers."""
    npcs = (rng.rand(m, 3) - 0.5).astype(np.float32)
    r = Rotation.from_rotvec(rng.randn(3)).as_matrix()
    xyz = 0.4 * npcs @ r + rng.randn(3) * 0.3 + rng.randn(m, 3) * noise
    bad = rng.rand(m) < outliers
    xyz[bad] = rng.rand(int(bad.sum()), 3) - 0.5
    return npcs, xyz.astype(np.float32)


@pytest.mark.parametrize("seed", range(3))
def test_umeyama_matches(seed):
    rng = np.random.RandomState(seed)
    src, tgt = _similar(rng, 60)
    mask = rng.rand(60) > 0.3
    want = jax_umeyama(jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(mask))
    got = umeyama_masked(torch.from_numpy(src), torch.from_numpy(tgt), torch.from_numpy(mask))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)
    # a batch gives what its rows give one by one
    batch = umeyama_masked(torch.from_numpy(np.stack([src, tgt])), torch.from_numpy(np.stack([tgt, src])),
                           torch.from_numpy(np.stack([mask, ~mask])))
    single = umeyama_masked(torch.from_numpy(tgt), torch.from_numpy(src), torch.from_numpy(~mask))
    for b, s in zip(batch, single):
        np.testing.assert_allclose(b[1].numpy(), s.numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("seed", range(2))
def test_ransac_matches_given_jax_draws(seed):
    """A batch of four proposals (clean, with outliers, padded, random),
    vmapped on the JAX side as the inference API does."""
    rng = np.random.RandomState(seed)
    m = 200
    npcs = np.zeros((4, m, 3), np.float32)
    xyz = np.zeros((4, m, 3), np.float32)
    mask = np.ones((4, m), bool)
    npcs[0], xyz[0] = _similar(rng, m)
    npcs[1], xyz[1] = _similar(rng, m, outliers=0.3)
    npcs[2, :120], xyz[2, :120] = _similar(rng, 120, outliers=0.1)
    mask[2, 120:] = False
    npcs[3] = (rng.rand(m, 3) - 0.5).astype(np.float32)
    xyz[3] = rng.rand(m, 3).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(seed), 4)
    want = jax.vmap(lambda s, t, k, key: jax_ransac(s, t, k, key, max_iters=50))(
        jnp.asarray(npcs), jnp.asarray(xyz), jnp.asarray(mask), keys)
    samples = torch.from_numpy(jax_draws(mask, keys, 50))
    got = ransac_pose_from_npcs(torch.from_numpy(npcs), torch.from_numpy(xyz), torch.from_numpy(mask),
                                samples)
    np.testing.assert_array_equal(got.ok.numpy(), np.asarray(want.ok))
    np.testing.assert_array_equal(got.inlier_mask.numpy(), np.asarray(want.inlier_mask))
    assert got.ok[:3].all()
    for f in ("bbox", "scale", "rotation", "translation"):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                   rtol=TOL, atol=TOL, err_msg=f)


def test_ransac_samples():
    """Draws with replacement among valid rows only, repeatable from the
    generator; a row with no valid entry still draws."""
    mask = torch.zeros((3, 50), dtype=torch.bool)
    mask[0, :10] = True
    mask[1, ::7] = True
    a = ransac_samples(mask, 40, torch.Generator().manual_seed(3))
    b = ransac_samples(mask, 40, torch.Generator().manual_seed(3))
    assert a.shape == (3, 40, 5) and torch.equal(a, b)
    assert bool(mask[0][a[0]].all()) and bool(mask[1][a[1]].all())
    assert len(torch.unique(a[0])) == 10 and int(a[2].max()) < 50


def test_rigid_cpd_matches():
    rng = np.random.RandomState(0)
    y = rng.rand(250, 3)
    r = Rotation.from_rotvec([0.3, -0.2, 0.4]).as_matrix().T
    x = (1.3 * (y @ r) + np.array([0.2, -0.1, 0.05])).astype(np.float32)
    y = y[rng.permutation(len(y))].astype(np.float32)
    want = jax_cpd(jnp.asarray(x), jnp.asarray(y))
    got = rigid_cpd(torch.from_numpy(x), torch.from_numpy(y))
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(float(got[3]), float(want[3]), rtol=1e-2, atol=TOL)


@pytest.mark.parametrize("method", ["ransac", "cpd"])
def test_joint_angle_matches(method):
    """tests/test_infer.py's rotations about a known axis and pivot; the
    CPD branch gets frame b shuffled (no correspondence)."""
    rng = np.random.RandomState(0)
    pts = rng.rand(300, 3)
    angle = 0.5
    c, s = np.cos(angle), np.sin(angle)
    r = np.array([[c, s, 0], [-s, c, 0], [0, 0, 1.0]])
    pivot = np.array([0.5, -0.2, 0.3])
    pts_b = (pts - pivot) @ r + pivot
    if method == "cpd":
        pts_b = pts_b[rng.permutation(len(pts_b))]
    want = jax_joint(pts, pts_b, method=method)
    got = estimate_joint_angle(pts, pts_b, method=method, device="cpu")
    for k in ("angle_rad", "rotation", "pivot"):
        np.testing.assert_allclose(got[k], want[k], rtol=TOL, atol=TOL, err_msg=k)
    np.testing.assert_allclose(np.abs(got["axis"]), np.abs(want["axis"]), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(abs(got["angle_rad"]), angle, atol=5e-3)
