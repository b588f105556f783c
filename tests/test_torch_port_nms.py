"""ops/nms.py of the port against the JAX package's: the dense point-set
IoU (within 1e-6) and greedy NMS (keep masks equal), P = 32, N = 512."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gapartnet_tpu.ops.nms import nms_single as jax_nms
from gapartnet_tpu.ops.nms import pairwise_pointset_iou as jax_iou
from gapartnet_tpu_torch.ops.nms import nms_single, pairwise_pointset_iou

P, N = 32, 512


def _proposals(rng):
    """Overlapping point sets: each proposal a random window of the points,
    some entries masked, some with no proposal."""
    ep, pid = [], []
    for p in range(P):
        start, size = rng.randint(0, N - 64), rng.randint(4, 64)
        pts = rng.choice(np.arange(start, start + 64), size, replace=False)
        ep.append(pts)
        pid.append(np.full(size, p))
    ep, pid = np.concatenate(ep)[: 2 * N], np.concatenate(pid)[: 2 * N]
    pad = 2 * N - len(ep)
    ep = np.concatenate([ep, rng.randint(0, N, pad)]).astype(np.int32)
    pid = np.concatenate([pid, np.full(pad, -1)]).astype(np.int32)
    em = (pid >= 0) & (rng.rand(2 * N) > 0.05)
    sizes = np.bincount(pid[em], minlength=P).astype(np.int32)
    return ep, pid, em, sizes


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("threshold", [0.05, 0.3])
def test_iou_and_nms_match(seed, threshold):
    rng = np.random.RandomState(seed)
    ep, pid, em, sizes = _proposals(rng)
    want_iou = np.asarray(jax_iou(jnp.asarray(ep), jnp.asarray(pid), jnp.asarray(em),
                                  jnp.asarray(sizes), num_points=N))
    got_iou = pairwise_pointset_iou(torch.from_numpy(ep), torch.from_numpy(pid), torch.from_numpy(em),
                                    torch.from_numpy(sizes), N).numpy()
    np.testing.assert_allclose(got_iou, want_iou, rtol=0, atol=1e-6)
    scores = rng.rand(P).astype(np.float32)
    scores[5] = scores[9] = scores[11]          # ties keep the stable order
    valid = (rng.rand(P) > 0.2) & (sizes > 3)
    want = np.asarray(jax_nms(jnp.asarray(want_iou), jnp.asarray(scores), jnp.asarray(valid), threshold))
    got = nms_single(torch.from_numpy(got_iou), torch.from_numpy(scores), torch.from_numpy(valid),
                     threshold).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < valid.sum()          # NMS suppressed something
