"""MaskedBatchNorm in training: the port against the flax module.

Output, input and parameter gradients, and the updated running statistics
(flax `mutable=["batch_stats"]`), with and without a validity mask, at
rtol = atol = 1e-5 (float32, sums in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gapartnet_tpu.models.norm import MaskedBatchNorm as JaxBN
from gapartnet_tpu_torch.models.norm import MaskedBatchNorm

TOL = 1e-5


@pytest.mark.parametrize("masked", [True, False])
def test_train_mode_matches_flax(masked):
    rng = np.random.RandomState(3)
    x = (rng.randn(2, 50, 6) * 2 + 0.5).astype(np.float32)
    mask = rng.rand(2, 50) < 0.7 if masked else None
    r = rng.randn(2, 50, 6).astype(np.float32)            # loss weights
    scale = (rng.rand(6) + 0.5).astype(np.float32)
    bias = rng.randn(6).astype(np.float32)
    stats = {"mean": rng.randn(6).astype(np.float32), "var": (rng.rand(6) + 0.5).astype(np.float32)}

    bn = JaxBN()

    def loss(params, xx):
        y, mut = bn.apply({"params": params, "batch_stats": stats}, xx,
                          None if mask is None else jnp.asarray(mask), True,
                          mutable=["batch_stats"])
        return (y * r).sum(), (y, mut["batch_stats"])

    (_, (want_y, want_stats)), (gp, gx) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}, jnp.asarray(x))

    tb = MaskedBatchNorm(6)
    with torch.no_grad():
        tb.weight.copy_(torch.from_numpy(scale))
        tb.bias.copy_(torch.from_numpy(bias))
        tb.running_mean.copy_(torch.from_numpy(stats["mean"]))
        tb.running_var.copy_(torch.from_numpy(stats["var"]))
    tb.train()
    tx = torch.from_numpy(x).requires_grad_(True)
    y = tb(tx, None if mask is None else torch.from_numpy(mask))
    (y * torch.from_numpy(r)).sum().backward()

    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want_y), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tb.weight.grad.numpy(), np.asarray(gp["scale"]), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tb.bias.grad.numpy(), np.asarray(gp["bias"]), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tb.running_mean.numpy(), np.asarray(want_stats["mean"]), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tb.running_var.numpy(), np.asarray(want_stats["var"]), rtol=TOL, atol=TOL)


def test_eval_mode_ignores_mask_and_keeps_stats():
    tb = MaskedBatchNorm(4).eval()
    x = torch.randn(3, 10, 4)
    with torch.no_grad():
        a = tb(x, torch.rand(3, 10) < 0.5)
        b = tb(x)
    assert torch.equal(a, b)
    assert torch.equal(tb.running_mean, torch.zeros(4)) and torch.equal(tb.running_var, torch.ones(4))


def test_constant_channel_is_finite():
    """A channel with zero batch variance: var = max(var, 0) keeps the
    normalization and its gradient finite."""
    tb = MaskedBatchNorm(2).train()
    x = torch.ones(1, 8, 2)
    x[..., 1] = torch.arange(8.0)
    x.requires_grad_(True)
    tb(x).sum().backward()
    assert bool(torch.isfinite(x.grad).all()) and bool(torch.isfinite(tb.running_var).all())
