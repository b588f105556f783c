"""Submanifold conv: the port's plain version against the JAX package, the
wrapper's checks, and (on a CUDA card only) the kernel against the plain
version.

The plain version is held against JAX `subm_conv_apply` and against the
Pallas kernel `subm_conv_pallas` in interpret mode, at rtol = atol = 1e-4
(float32, sums in another order).

The card tests need no JAX: on a machine with a card and without JAX they
run with `python -m pytest --noconftest tests/test_torch_port_subm_conv.py
-m cuda`, so this module imports JAX only inside the CPU parity tests.
"""

import numpy as np
import pytest
import torch

from gapartnet_tpu_torch.ops import sparse_conv as ts
from gapartnet_tpu_torch.ops.voxelize import KEY_SENTINEL
from gapartnet_tpu_torch.ops.subm_conv import subm_conv, subm_conv_reference

TOL = 1e-4


def _grid(seed, b=2, cap=300, active=(250, 180), grid=9):
    import jax
    import jax.numpy as jnp

    from gapartnet_tpu.ops.sparse_conv import build_subm_rulebook

    rng = np.random.RandomState(seed)
    keys = np.full((b, cap), KEY_SENTINEL, np.int32)
    allc = np.stack(np.meshgrid(*[np.arange(grid)] * 3, indexing="ij"), -1).reshape(-1, 3)
    for i in range(b):
        c = allc[rng.choice(len(allc), active[i], replace=False)]
        keys[i, : active[i]] = np.sort((c[:, 0] << 20) | (c[:, 1] << 10) | c[:, 2])
    nbr = np.array(jax.vmap(lambda k: build_subm_rulebook(k, 3))(jnp.asarray(keys)))
    return keys, nbr


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
    x = torch.from_numpy(rng.randn(2, 300, 8).astype(np.float32))
    w = torch.from_numpy(rng.randn(27, 8, 4).astype(np.float32))
    before = subm_conv.launches
    out = subm_conv(x, torch.from_numpy(nbr), w)
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
    before = subm_conv.launches
    with torch.no_grad():
        got = subm_conv(x.to(dev), nbr.to(dev), w.to(dev))
    torch.cuda.synchronize()
    assert subm_conv.launches == before + 1
    torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)
    # deterministic: no atomics
    with torch.no_grad():
        again = subm_conv(x.to(dev), nbr.to(dev), w.to(dev))
    assert torch.equal(got, again)


@pytest.mark.cuda
def test_kernel_refuses_grad_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    x = torch.zeros(1, 10, 4, device="cuda", requires_grad=True)
    nbr = torch.full((1, 27, 10), -1, dtype=torch.int32, device="cuda")
    w = torch.zeros(27, 4, 3, device="cuda")
    with pytest.raises(NotImplementedError):
        subm_conv(x, nbr, w)
