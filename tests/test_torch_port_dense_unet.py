"""Dense proposal UNet (eval ScoreNet / NPCSNet): the port's dense forward
of ProposalUNet against the JAX module, with the JAX weights carried over by params_from_jax and random
batch statistics, at rtol = atol = 1e-4 (float32 convs, sums in another
order)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from gapartnet_tpu.models.dense_unet import DenseProposalUNet as JaxUNet
from gapartnet_tpu.models.dense_unet import downsample_occupancy as jax_down_occ
from gapartnet_tpu_torch.models.dense_unet import ProposalUNet, downsample_occupancy
from gapartnet_tpu_torch.weights import params_from_jax

TOL = 1e-4


def _random_stats(tree, rng):
    if set(tree) == {"mean", "var"}:
        c = np.asarray(tree["mean"]).shape[0]
        return {"mean": (rng.randn(c) * 0.1).astype(np.float32),
                "var": (rng.rand(c) + 0.5).astype(np.float32)}
    return {k: _random_stats(v, rng) for k, v in tree.items()}


def _grid(rng, g=3, s=8, c=8, fill=0.2):
    occ = rng.rand(g, s, s, s) < fill
    x = rng.randn(g, s, s, s, c).astype(np.float32) * occ[..., None]
    return x.astype(np.float32), occ


def test_dense_unet_matches():
    rng = np.random.RandomState(0)
    x, occ = _grid(rng)
    channels = (8, 16)
    jm = JaxUNet(channels, 2)
    variables = jax.jit(lambda a, o: jm.init(jax.random.PRNGKey(0), a, o, False))(x, occ)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    variables = {"params": variables["params"],
                 "batch_stats": _random_stats(variables["batch_stats"], rng)}
    want = np.asarray(jax.jit(lambda v, a, o: jm.apply(v, a, o, False))(variables, x, occ))

    tm = ProposalUNet(channels, 2)
    tm.load_state_dict(params_from_jax(variables), strict=True)
    tm.eval()
    with torch.no_grad():
        got = tm.dense(torch.from_numpy(x), torch.from_numpy(occ)).numpy()
    assert got.shape == want.shape == (3, 8, 8, 8, 8)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    # unoccupied sites stay zero
    assert (got[~occ] == 0).all()
    assert np.abs(got[occ]).max() > 0


def test_downsample_occupancy_matches():
    occ = np.random.RandomState(1).rand(2, 6, 6, 6) < 0.1
    np.testing.assert_array_equal(
        downsample_occupancy(torch.from_numpy(occ)).numpy(), np.asarray(jax_down_occ(jnp.asarray(occ)))
    )
