"""Submanifold conv: the port's plain versions against the JAX package, the
wrappers' checks, and (on a CUDA card only) the kernels against the plain
versions.

The plain forward is held against JAX `subm_conv_apply` and against the
Pallas kernel `subm_conv_pallas` in interpret mode, and the port's
gradients (d_features, d_weights) against `jax.vjp` of both, on a rulebook
with out-of-extent voxels (not symmetric), at rtol = atol = 1e-4 (float32,
sums in another order).

The card tests need no JAX: on a machine with a card and without JAX they
run with `python -m pytest --noconftest tests/test_torch_port_subm_conv.py
-m cuda`, so this module imports JAX only inside the CPU parity tests.
"""

import numpy as np
import pytest
import torch

from gapartnet_tpu_torch.ops import sparse_conv as ts
from gapartnet_tpu_torch.ops.voxelize import KEY_SENTINEL
from gapartnet_tpu_torch.ops.subm_conv import (
    subm_conv,
    subm_conv_dgrad,
    subm_conv_dgrad_reference,
    subm_conv_reference,
    subm_conv_wgrad,
    subm_conv_wgrad_reference,
)

TOL = 1e-4


def _grid(seed, b=2, cap=300, active=(250, 180), grid=9, extent=None):
    import jax
    import jax.numpy as jnp

    from gapartnet_tpu.ops.sparse_conv import build_subm_rulebook

    rng = np.random.RandomState(seed)
    keys = np.full((b, cap), KEY_SENTINEL, np.int32)
    allc = np.stack(np.meshgrid(*[np.arange(grid)] * 3, indexing="ij"), -1).reshape(-1, 3)
    for i in range(b):
        c = allc[rng.choice(len(allc), active[i], replace=False)]
        keys[i, : active[i]] = np.sort((c[:, 0] << 20) | (c[:, 1] << 10) | c[:, 2])
    nbr = np.array(jax.vmap(lambda k: build_subm_rulebook(k, 3, extent=extent))(jnp.asarray(keys)))
    return keys, nbr


def _asymmetric_case(seed):
    """A rulebook whose voxels at x = 8 lie outside the extent (8, 9, 9):
    they read their in-extent neighbours at x = 7, which do not read them."""
    _, nbr = _grid(seed, extent=(8, 9, 9))
    b, k, v = nbr.shape
    asym = 0
    for bi in range(b):
        for t in range(k):
            for i in np.nonzero(nbr[bi, t] >= 0)[0]:
                asym += nbr[bi, k - 1 - t, nbr[bi, t, i]] != i
    assert asym > 0, "the rulebook came out symmetric"
    rng = np.random.RandomState(seed)
    x = rng.randn(b, v, 8).astype(np.float32)
    w = (rng.randn(27, 8, 12) / np.sqrt(27 * 8)).astype(np.float32)
    g = rng.randn(b, v, 12).astype(np.float32)
    return x, nbr, w, g


def _port_grads(x, nbr, w, g):
    tx = torch.from_numpy(x).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    out = subm_conv(tx, torch.from_numpy(nbr), tw)
    out.backward(torch.from_numpy(g))
    return tx.grad.numpy(), tw.grad.numpy()


@pytest.mark.parametrize("impl", ["xla", "pallas_interpret"])
def test_gradients_match_jax_vjp(impl):
    import contextlib

    import jax
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from gapartnet_tpu.ops.pallas_conv import subm_conv_pallas
    from gapartnet_tpu.ops.sparse_conv import subm_conv_apply

    x, nbr, w, g = _asymmetric_case(11)
    fn = subm_conv_apply if impl == "xla" else subm_conv_pallas
    ctx = pltpu.force_tpu_interpret_mode() if impl != "xla" else contextlib.nullcontext()
    with ctx:
        _, vjp = jax.vjp(lambda a, c: fn(a, jnp.asarray(nbr), c), jnp.asarray(x), jnp.asarray(w))
        want_x, want_w = vjp(jnp.asarray(g))
    got_x, got_w = _port_grads(x, nbr, w, g)
    np.testing.assert_allclose(got_x, np.asarray(want_x), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got_w, np.asarray(want_w), rtol=TOL, atol=TOL)


def test_dgrad_is_the_flipped_conv_not_the_adjoint():
    """On an asymmetric rulebook the flipped-weight dgrad (what the JAX VJP
    computes) differs from autograd's adjoint of the plain forward."""
    x, nbr, w, g = _asymmetric_case(12)
    got_x, _ = _port_grads(x, nbr, w, g)
    tx = torch.from_numpy(x).requires_grad_(True)
    subm_conv_reference(tx, torch.from_numpy(nbr), torch.from_numpy(w)).backward(torch.from_numpy(g))
    assert np.abs(got_x - tx.grad.numpy()).max() > 1e-3
    flipped = subm_conv_dgrad_reference(torch.from_numpy(g), torch.from_numpy(nbr), torch.from_numpy(w))
    np.testing.assert_array_equal(got_x, flipped.numpy())


def test_wgrad_reference_is_the_adjoint_in_weights():
    """The weight gradient is the exact adjoint of the forward in W."""
    x, nbr, w, g = _asymmetric_case(13)
    tw = torch.from_numpy(w).requires_grad_(True)
    subm_conv_reference(torch.from_numpy(x), torch.from_numpy(nbr), tw).backward(torch.from_numpy(g))
    got = subm_conv_wgrad_reference(torch.from_numpy(x), torch.from_numpy(nbr), torch.from_numpy(g))
    np.testing.assert_allclose(got.numpy(), tw.grad.numpy(), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("cin,cout", [(6, 16), (8, 8), (32, 16)])
def test_reference_matches_jax(cin, cout):
    import jax.numpy as jnp

    from gapartnet_tpu.ops.sparse_conv import subm_conv_apply

    rng = np.random.RandomState(cin)
    _, nbr = _grid(cin)
    x = rng.randn(2, 300, cin).astype(np.float32)
    w = (rng.randn(27, cin, cout) / np.sqrt(27 * cin)).astype(np.float32)
    want = np.asarray(subm_conv_apply(jnp.asarray(x), jnp.asarray(nbr), jnp.asarray(w)))
    got = subm_conv_reference(torch.from_numpy(x), torch.from_numpy(nbr), torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def test_reference_matches_pallas_interpret():
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from gapartnet_tpu.ops.pallas_conv import subm_conv_pallas

    rng = np.random.RandomState(7)
    _, nbr = _grid(7)
    x = rng.rand(2, 300, 8).astype(np.float32)
    w = (rng.rand(27, 8, 16) - 0.5).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(subm_conv_pallas(jnp.asarray(x), jnp.asarray(nbr), jnp.asarray(w)))
    got = subm_conv_reference(torch.from_numpy(x), torch.from_numpy(nbr), torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def test_cpu_path_counts_no_launch():
    rng = np.random.RandomState(1)
    _, nbr = _grid(1)
    x = torch.from_numpy(rng.randn(2, 300, 8).astype(np.float32)).requires_grad_(True)
    w = torch.from_numpy(rng.randn(27, 8, 4).astype(np.float32)).requires_grad_(True)
    before = dict(subm_conv.launches)
    out = subm_conv(x, torch.from_numpy(nbr), w)
    out.sum().backward()
    assert subm_conv.launches == before
    torch.testing.assert_close(out, subm_conv_reference(x, torch.from_numpy(nbr), w), rtol=0, atol=0)


def test_port_rulebook_feeds_reference():
    """The port's own rulebook gives the JAX conv result."""
    keys, nbr = _grid(2)
    tn = ts.build_subm_rulebook(torch.from_numpy(keys))
    np.testing.assert_array_equal(tn.numpy(), nbr)


@pytest.mark.parametrize("bad", ["dtype", "nbr_dtype", "shape", "contiguous", "weights"])
def test_wrapper_rejects_bad_inputs(bad):
    x = torch.zeros(1, 10, 4)
    nbr = torch.full((1, 27, 10), -1, dtype=torch.int32)
    w = torch.zeros(27, 4, 3)
    if bad == "dtype":
        x = x.double()
    elif bad == "nbr_dtype":
        nbr = nbr.long()
    elif bad == "shape":
        nbr = nbr[:, :26]
    elif bad == "contiguous":
        x = torch.zeros(1, 4, 10).transpose(1, 2)
    elif bad == "weights":
        w = torch.zeros(27, 5, 3)
    with pytest.raises((TypeError, ValueError)):
        subm_conv(x, nbr, w)


@pytest.mark.parametrize("bad", ["grad_shape", "grad_dtype", "dgrad_weights"])
def test_backward_wrappers_reject_bad_inputs(bad):
    x = torch.zeros(1, 10, 4)
    nbr = torch.full((1, 27, 10), -1, dtype=torch.int32)
    g = torch.zeros(1, 10, 3)
    with pytest.raises((TypeError, ValueError)):
        if bad == "grad_shape":
            subm_conv_wgrad(x, nbr, torch.zeros(1, 9, 3))
        elif bad == "grad_dtype":
            subm_conv_wgrad(x, nbr, g.double())
        else:
            subm_conv_dgrad(g, nbr, torch.zeros(27, 4, 5))


@pytest.mark.cuda
@pytest.mark.parametrize("cin,cout,v", [(6, 16, 1000), (16, 16, 777), (224, 112, 300),
                                        (32, 224, 130), (192, 96, 64), (5, 7, 33)])
def test_kernel_matches_reference_on_card(cin, cout, v):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    gen = torch.Generator().manual_seed(cin * 1000 + cout)
    x = torch.randn((2, v, cin), generator=gen)
    w = torch.randn((27, cin, cout), generator=gen) / (27 * cin) ** 0.5
    nbr = torch.randint(-v // 2, v, (2, 27, v), generator=gen, dtype=torch.int32).clamp(min=-1)
    dev = torch.device("cuda")
    want = subm_conv_reference(x.to(dev), nbr.to(dev), w.to(dev))
    before = dict(subm_conv.launches)
    with torch.no_grad():
        got = subm_conv(x.to(dev), nbr.to(dev), w.to(dev))
    torch.cuda.synchronize()
    assert subm_conv.launches["fwd"] == before["fwd"] + 1
    torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)
    # deterministic: no atomics
    with torch.no_grad():
        again = subm_conv(x.to(dev), nbr.to(dev), w.to(dev))
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("cin,cout,v", [(6, 16, 1000), (16, 16, 777), (112, 224, 300),
                                        (16, 32, 130), (96, 192, 64), (5, 7, 33)])
def test_kernel_gradients_on_card(cin, cout, v):
    """dgrad and wgrad kernels against their plain versions, through
    autograd; the dgrad at swapped shapes reaches Cout > 112 (64-wide
    tiles) and the split-tap pass; the wgrad is bitwise repeatable.  The
    wgrad sums over B * V rows, so its tolerance is 1e-4 of max|ref|."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    gen = torch.Generator().manual_seed(cin * 1000 + cout + 1)
    dev = torch.device("cuda")
    x = torch.randn((2, v, cin), generator=gen).to(dev)
    w = (torch.randn((27, cin, cout), generator=gen) / (27 * cin) ** 0.5).to(dev)
    g = torch.randn((2, v, cout), generator=gen).to(dev)
    nbr = torch.randint(-v // 2, v, (2, 27, v), generator=gen, dtype=torch.int32).clamp(min=-1).to(dev)
    before = dict(subm_conv.launches)
    tx, tw = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    subm_conv(tx, nbr, tw).backward(g)
    torch.cuda.synchronize()
    assert subm_conv.launches["dgrad"] == before["dgrad"] + 1
    assert subm_conv.launches["wgrad"] == before["wgrad"] + 1
    want_x = subm_conv_dgrad_reference(g, nbr, w)
    want_w = subm_conv_wgrad_reference(x, nbr, g)
    assert float((tx.grad - want_x).abs().max()) <= TOL * float(want_x.abs().max())
    assert float((tw.grad - want_w).abs().max()) <= TOL * float(want_w.abs().max())
    assert torch.equal(subm_conv_wgrad(x, nbr, g), subm_conv_wgrad(x, nbr, g))
    assert torch.equal(subm_conv_dgrad(g, nbr, w), tx.grad)
