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
    LAUNCH_COUNTERS,
    subm_conv,
    subm_conv_dgrad,
    subm_conv_dgrad_reference,
    subm_conv_reference,
    subm_conv_wgrad,
    subm_conv_wgrad_reference,
)
from gapartnet_tpu_torch.utils import profiling

TOL = 1e-4


def _launched(rec):
    """{kind: launches} of the subm-conv kernels in a profiling recording."""
    return {kind: rec.counts.get(name, 0) for kind, name in LAUNCH_COUNTERS.items()}


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
    with profiling.record() as rec:
        out = subm_conv(x, torch.from_numpy(nbr), w)
        out.sum().backward()
    assert not any(_launched(rec).values())
    torch.testing.assert_close(out, subm_conv_reference(x, torch.from_numpy(nbr), w), rtol=0, atol=0)


def test_build_compiles_only_the_sources_asked_for(tmp_path, monkeypatch):
    """`build` compiles the conv kernels' four sources by default and only
    the exact CCL's when ops/ccl.py asks for it (a stand-in nvcc writes
    empty libraries)."""
    from gapartnet_tpu_torch.ops import ccl
    from gapartnet_tpu_torch.ops import subm_conv as sc

    nvcc = tmp_path / "nvcc"
    nvcc.write_text('#!/bin/sh\nwhile [ $# -gt 0 ]; do [ "$1" = -o ] && : > "$2"; shift; done\n')
    nvcc.chmod(0o755)
    monkeypatch.setattr(sc, "find_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(sc, "BUILD_DIR", tmp_path / "build")
    libs = sc.build((ccl.SOURCE,))
    assert list(libs) == ["ccl_exact"] and libs["ccl_exact"].exists()
    assert sorted(p.name for p in (tmp_path / "build").glob("*.so")) == [libs["ccl_exact"].name]
    assert list(sc.build()) == ["subm_conv", "subm_conv_wgrad", "subm_conv_bf16",
                                "subm_conv_wgrad_bf16"]
    assert len(list((tmp_path / "build").glob("*.so"))) == 5


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


def tf32_rna(a: np.ndarray) -> np.ndarray:
    """float32 -> float32 rounded to TF32 (10 mantissa bits) as the card's
    cvt.rna does: to nearest on the low 13 bits, ties away from zero."""
    bits = np.ascontiguousarray(a, dtype=np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def test_tf32_rounding_is_nearest_ties_away():
    ulp = 2.0 ** -10
    a = np.array([1 + ulp / 2, -(1 + ulp / 2), 1 + ulp / 2 - 2.0 ** -23, 1 + 0.75 * ulp, 3.0],
                 np.float32)
    np.testing.assert_array_equal(tf32_rna(a), [1 + ulp, -(1 + ulp), 1.0, 1 + ulp, 3.0])


def _tf32_split(a: np.ndarray):
    hi = tf32_rna(a)
    return hi, tf32_rna(a - hi)


def _conv_3xtf32(a: np.ndarray, w: np.ndarray, single: bool = False) -> np.ndarray:
    """(V, K) @ (K, N) as the kernels compute it: per k-step of 8, the
    products lo*hi, hi*lo and hi*hi (exact for TF32 operands) added in that
    order to a float32 accumulator; `single` keeps hi*hi alone."""
    (ah, al), (wh, wl) = _tf32_split(a), _tf32_split(w)
    terms = [(ah, wh)] if single else [(al, wh), (ah, wl), (ah, wh)]
    acc = np.zeros((a.shape[0], w.shape[1]), np.float32)
    for k0 in range(0, a.shape[1], 8):
        for x, y in terms:
            acc += (x[:, k0:k0 + 8].astype(np.float64) @ y[k0:k0 + 8].astype(np.float64)).astype(np.float32)
    return acc


@pytest.mark.parametrize("cin", [6, 16, 32, 112, 224])
def test_3xtf32_conv_matches_float64(cin):
    """The kernels' numerics, emulated: a 3xTF32 gather-GEMM at K = 27 * Cin
    stays within 1e-5 of max|ref| of a float64 conv.  Single-pass TF32 is
    printed for comparison (run with -s), not asserted."""
    rng = np.random.RandomState(cin)
    v, cout = 256, 32
    pad = -(-cin // 8) * 8 - cin              # zero columns up to the mma K add nothing
    x = rng.randn(v, cin).astype(np.float32)
    w = (rng.randn(27, cin, cout) / np.sqrt(27 * cin)).astype(np.float32)
    nbr = np.where(rng.rand(27, v) < 0.45, rng.randint(0, v, (27, v)), -1)
    a = np.where((nbr >= 0)[..., None], x[np.maximum(nbr, 0)], 0).transpose(1, 0, 2)
    a = np.pad(a, ((0, 0), (0, 0), (0, pad))).reshape(v, -1).astype(np.float32)
    wk = np.pad(w, ((0, 0), (0, pad), (0, 0))).reshape(-1, cout)
    ref = a.astype(np.float64) @ wk.astype(np.float64)
    scale = np.abs(ref).max()
    err3 = np.abs(_conv_3xtf32(a, wk) - ref).max() / scale
    err1 = np.abs(_conv_3xtf32(a, wk, single=True) - ref).max() / scale
    print(f"K = 27 * {cin}: max|d| / max|ref| 3xTF32 {err3:.2e}, single-pass TF32 {err1:.2e}")
    assert err3 <= 1e-5
    np.testing.assert_allclose(_conv_3xtf32(a, wk), subm_conv_reference(
        torch.from_numpy(x)[None], torch.from_numpy(nbr.astype(np.int32))[None],
        torch.from_numpy(w))[0].numpy(), rtol=0, atol=1e-5 * scale)


def _card_case(cin, cout, v, pattern, seed):
    """Seeded card inputs: x (2, V, Cin), W (27, Cin, Cout), g (2, V, Cout)
    and a random neighbour table.  "holes" also empties tap 3 in every row,
    voxels 128-255 of the second cloud at every tap (a voxel tile with no
    neighbour) and the first three quarters of the first cloud (row chunks
    of the wgrad with no present row)."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((2, v, cin), generator=gen)
    w = torch.randn((27, cin, cout), generator=gen) / (27 * cin) ** 0.5
    g = torch.randn((2, v, cout), generator=gen)
    nbr = torch.randint(-v // 2, v, (2, 27, v), generator=gen, dtype=torch.int32).clamp(min=-1)
    if pattern == "holes":
        nbr[:, 3] = -1
        nbr[1, :, 128:256] = -1
        nbr[0, :, : 3 * v // 4] = -1
    dev = torch.device("cuda")
    return x.to(dev), w.to(dev), g.to(dev), nbr.to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("cin,cout,v,pattern", [
    (6, 16, 1000, "random"), (16, 16, 777, "random"), (224, 112, 300, "random"),
    (32, 224, 130, "random"), (192, 96, 64, "random"), (5, 7, 33, "random"),
    (16, 192, 1, "random"), (16, 16, 2500, "holes"), (224, 7, 300, "holes"),
    (6, 224, 129, "holes"), (40, 48, 200, "random"),
])
def test_kernel_matches_reference_on_card(cin, cout, v, pattern):
    """Cin 5 and 6 take 4-byte copies and 8-channel chunks; Cin 16 is one
    16-channel chunk, 224 fourteen, 40 ends in a half-empty one; Cout 7, 48,
    192 and 224 cover one to four channel tiles; V = 1 and V not a multiple
    of the 128-voxel tile."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    x, w, _, nbr = _card_case(cin, cout, v, pattern, cin * 1000 + cout)
    want = subm_conv_reference(x, nbr, w)
    with torch.no_grad(), profiling.record() as rec:
        got = subm_conv(x, nbr, w)
        torch.cuda.synchronize()
    assert _launched(rec)["fwd"] == 1
    torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)
    # deterministic: no atomics
    with torch.no_grad():
        again = subm_conv(x, nbr, w)
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("cin,cout,v,pattern", [
    (6, 16, 1000, "random"), (16, 16, 777, "random"), (112, 224, 300, "random"),
    (16, 32, 130, "random"), (96, 192, 64, "random"), (5, 7, 33, "random"),
    (224, 16, 1, "random"), (16, 16, 2500, "holes"), (7, 224, 300, "holes"),
    (224, 224, 260, "holes"), (40, 48, 700, "holes"),
])
def test_kernel_gradients_on_card(cin, cout, v, pattern):
    """dgrad and wgrad kernels against their plain versions, through
    autograd; the dgrad at swapped shapes reaches Cout up to 224 (four
    channel tiles) and the split-tap pass; the wgrad takes 4-byte copies of
    one operand or both (Cin 5, 6, 7; Cout 7) and every channel tile (Cout
    48: the 48-wide one); all three kernels are bitwise repeatable.  The
    wgrad sums over B * V rows, so its tolerance is 1e-4 of max|ref|."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    x, w, g, nbr = _card_case(cin, cout, v, pattern, cin * 1000 + cout + 1)
    tx, tw = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    with profiling.record() as rec:
        subm_conv(tx, nbr, tw).backward(g)
        torch.cuda.synchronize()
    assert _launched(rec)["dgrad"] == 1
    assert _launched(rec)["wgrad"] == 1
    want_x = subm_conv_dgrad_reference(g, nbr, w)
    want_w = subm_conv_wgrad_reference(x, nbr, g)
    assert float((tx.grad - want_x).abs().max()) <= TOL * float(want_x.abs().max())
    assert float((tw.grad - want_w).abs().max()) <= TOL * float(want_w.abs().max())
    assert torch.equal(subm_conv_wgrad(x, nbr, g), tw.grad)
    assert torch.equal(subm_conv_dgrad(g, nbr, w), tx.grad)
    assert torch.equal(subm_conv_wgrad(x, nbr, g), subm_conv_wgrad(x, nbr, g))


def _bf16_close(got: torch.Tensor, want: torch.Tensor, rtol: float) -> None:
    """A result rounded to bf16 against its plain version: within one bf16
    ulp of the value plus rtol of max|want| (the fp32 sums before the
    rounding differ in order)."""
    assert torch.equal(got, got.to(torch.bfloat16).float()), "not rounded to bf16"
    ulp = torch.exp2(torch.floor(torch.log2(want.abs().clamp(min=2.0 ** -126))) - 7)
    err = (got - want).abs() - ulp
    assert float(err.max()) <= rtol * float(want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("cin,cout,v,pattern", [
    (5, 7, 33, "random"), (6, 16, 1000, "random"), (16, 48, 777, "random"),
    (40, 192, 300, "random"), (224, 224, 130, "random"), (16, 192, 1, "random"),
    (16, 16, 2500, "holes"), (224, 7, 300, "holes"), (6, 224, 129, "holes"),
    (40, 48, 700, "holes"), (5, 224, 1, "random"),
    # the flagship widths: Cin 6 (the stem) to 192, Cout 16 to 112
    (6, 16, 5000, "holes"), (32, 16, 3000, "random"), (64, 32, 2000, "random"),
    (96, 48, 1500, "random"), (128, 64, 1000, "random"), (160, 80, 384, "random"),
    (192, 96, 128, "random"), (112, 112, 128, "holes"),
])
def test_bf16_kernels_match_reference_on_card(cin, cout, v, pattern):
    """The bf16 forward, dgrad and wgrad kernels against their plain
    versions, through the autograd function: Cin 5 and 6 (rows padded to
    8), 16 (one 16-channel chunk), 40 (a 32-channel chunk and a short one),
    224 (seven); Cout 7 to 224 (one to four channel tiles, and the same as
    the dgrad's K); V = 1, V not a multiple of the 128-voxel tile, an
    absent tap and an empty tile ("holes").  Forward within 1e-4 of scale
    (fp32 sums of exact products in another order); dgrad and wgrad,
    rounded to bf16, within one bf16 ulp plus 1e-4 (dgrad) or 1e-3 (wgrad,
    sums over B * V rows) of scale.  No fp32 kernel runs; every kernel is
    bitwise repeatable."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from gapartnet_tpu_torch.ops import subm_conv as sc

    x, w, g, nbr = _card_case(cin, cout, v, pattern, cin * 1000 + cout + 7)
    tx, tw = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    with profiling.record() as rec:
        out = sc.subm_conv(tx, nbr, tw, compute_dtype=torch.bfloat16)
        out.backward(g)
        torch.cuda.synchronize()
    assert _launched(rec) == {"fwd": 0, "dgrad": 0, "wgrad": 0,
                        "fwd_bf16": 1, "dgrad_bf16": 1, "wgrad_bf16": 1}
    want = sc.subm_conv_bf16_reference(x, nbr, w)
    assert float((out.detach() - want).abs().max()) <= TOL * float(want.abs().max())
    _bf16_close(tx.grad, sc.subm_conv_dgrad_bf16_reference(g, nbr, w), 1e-4)
    _bf16_close(tw.grad, sc.subm_conv_wgrad_bf16_reference(x, nbr, g), 1e-3)
    with torch.no_grad():
        assert torch.equal(sc.subm_conv_forward_bf16(x, nbr, w), out)
    assert torch.equal(sc.subm_conv_dgrad_bf16(g, nbr, w), tx.grad)
    assert torch.equal(sc.subm_conv_wgrad_bf16(x, nbr, g), tw.grad)
    assert torch.equal(sc.subm_conv_wgrad_bf16(x, nbr, g), sc.subm_conv_wgrad_bf16(x, nbr, g))


def _kernels_in_one_call(fn) -> int:
    """CUDA kernels one call of fn() launches (torch.profiler), the most of
    three windows (a window now and then loses kernels)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    most = 0
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        most = max(most, sum(e.count for e in prof.key_averages()
                             if e.device_type == DeviceType.CUDA))
    return most


@pytest.mark.cuda
@pytest.mark.parametrize("cin,cout,v", [(6, 16, 3000), (16, 16, 3000), (32, 32, 2000),
                                        (192, 96, 128), (96, 192, 300)])
def test_bf16_kernels_inputs_views_and_launches_on_card(cin, cout, v):
    """The bf16 kernels read float32 and bfloat16 operands alike (on values
    that are already bf16 the results are bitwise equal), and views whose
    rows are not 16-byte aligned (one float into their storage) give the
    same bits; every kernel is bitwise repeatable; a call is one kernel
    launch where its plan splits no taps and chunks no rows (no operand
    copy), else two."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from gapartnet_tpu_torch.ops import subm_conv as sc

    x, w, g, nbr = _card_case(cin, cout, v, "random", cin * 1000 + cout + 11)
    x, w, g = (t.to(torch.bfloat16).float() for t in (x, w, g))

    def unaligned(t):
        buf = torch.empty(t.numel() + 1, device=t.device, dtype=t.dtype)
        view = buf[1:].view(t.shape)
        view.copy_(t)
        assert view.data_ptr() % 16 != 0
        return view

    calls = {
        "fwd": lambda a, b_: sc.subm_conv_forward_bf16(a, nbr, b_),
        "dgrad": lambda a, b_: sc.subm_conv_dgrad_bf16(a, nbr, b_),
        "wgrad": lambda a, b_: sc.subm_conv_wgrad_bf16(a, nbr, b_),
    }
    args = {"fwd": (x, w), "dgrad": (g, w), "wgrad": (x, g)}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    b = x.shape[0]
    plans = {"fwd": 1 + (sc.bf16_forward_plan(b, v, cin, cout, sms)["splits"] > 1),
             "dgrad": 1 + (sc.bf16_forward_plan(b, v, cout, cin, sms)["splits"] > 1),
             "wgrad": 1 + (sc.bf16_wgrad_plan(b, v, cin, cout, sms)["chunks"] > 1)}
    for kind, fn in calls.items():
        a0, a1 = args[kind]
        with torch.no_grad():
            want = fn(a0, a1)
            assert torch.equal(fn(a0, a1), want), f"{kind}: not repeatable"
            assert torch.equal(fn(a0.to(torch.bfloat16), a1.to(torch.bfloat16)), want), kind
            assert torch.equal(fn(unaligned(a0), unaligned(a1)), want), f"{kind}: unaligned view"
            assert _kernels_in_one_call(lambda: fn(a0, a1)) == plans[kind], kind
