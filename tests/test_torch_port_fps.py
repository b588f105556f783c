"""ops/fps.py and the FPS downsampling of the inference API against the JAX
package's: indices equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gapartnet_tpu.infer.api import fps_downsample as jax_fps_downsample
from gapartnet_tpu.ops.fps import furthest_point_sampling_single as jax_fps
from gapartnet_tpu_torch.infer.api import fps_downsample
from gapartnet_tpu_torch.ops.fps import furthest_point_sampling_single


@pytest.mark.parametrize("seed,start_idx,masked", [(0, 0, False), (1, 17, True), (2, 311, True)])
def test_fps_matches(seed, start_idx, masked):
    rng = np.random.RandomState(seed)
    xyz = rng.rand(500, 3).astype(np.float32)
    valid = rng.rand(500) > 0.3 if masked else np.ones(500, bool)
    valid[start_idx] = True
    want = np.asarray(jax_fps(jnp.asarray(xyz), 100, jnp.asarray(valid), start_idx))
    got = furthest_point_sampling_single(torch.from_numpy(xyz), 100, torch.from_numpy(valid),
                                         start_idx).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32 and valid[got].all() and len(np.unique(got)) == 100


@pytest.mark.parametrize("n", [300, 900, 1700])
def test_fps_downsample_matches(n):
    """n <= num_samples (identity), the FPS alone, and the pre-crop to 4x."""
    xyz = np.random.RandomState(n).rand(n, 3).astype(np.float32)
    np.testing.assert_array_equal(fps_downsample(xyz, 400, device="cpu"), jax_fps_downsample(xyz, 400))
