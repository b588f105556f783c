"""The bf16 subm-conv path of the port (no JAX): the autograd function
against the plain versions on pre-rounded inputs, what it saves, and the
launch plans of the wgmma kernels (csrc/subm_conv_bf16.cu,
csrc/subm_conv_wgrad_bf16.cu) at every flagship shape.

The kernels run only on a card; their plans are computed in Python, so the
CPU can hold them to the card's limits: a block's shared memory within the
232,448 bytes an H100 block may use, an N tile that is a width the kernels
are built for (a legal wgmma N: a multiple of 8, at most 256) covering N in
one tile at every flagship width, tap splits and row chunks that leave none
empty."""

import numpy as np
import pytest
import torch

from gapartnet_tpu_torch.ops import subm_conv as sc

BF16 = torch.bfloat16
SMS = 132   # an H100 SXM's SMs
# (net, level, Cin, Cout, V at B = 8) of one flagship train step
# (configs/gapartnet.yaml widths; V from the bench clouds' hierarchy)
FLAGSHIP = [
    ("backbone", 0, 6, 16, 20000), ("backbone", 0, 16, 16, 20000), ("backbone", 0, 32, 16, 20000),
    ("backbone", 1, 32, 32, 14464), ("backbone", 1, 64, 32, 14464),
    ("backbone", 2, 48, 48, 4608), ("backbone", 2, 96, 48, 4608),
    ("backbone", 3, 64, 64, 1408), ("backbone", 3, 128, 64, 1408),
    ("backbone", 4, 80, 80, 384), ("backbone", 4, 160, 80, 384),
    ("backbone", 5, 96, 96, 128), ("backbone", 5, 192, 96, 128),
    ("backbone", 6, 112, 112, 128),
    ("proposal", 0, 16, 16, 8192), ("proposal", 0, 32, 16, 8192), ("proposal", 1, 32, 32, 4096),
]


def _case(cin, cout, seed, b=2, v=97):
    """Seeded operands and a random neighbour table with absent taps."""
    rng = np.random.RandomState(seed)
    nbr = rng.randint(-v // 2, v, size=(b, 27, v)).clip(min=-1).astype(np.int32)
    x = rng.randn(b, v, cin).astype(np.float32)
    w = (rng.randn(27, cin, cout) / np.sqrt(27 * cin)).astype(np.float32)
    g = rng.randn(b, v, cout).astype(np.float32)
    return (torch.from_numpy(t) for t in (x, nbr, w, g))


def _rounded(t):
    return t.to(BF16).float()


@pytest.mark.parametrize("cin,cout", [(6, 16), (16, 16), (40, 24)])
def test_bf16_autograd_matches_plain_on_rounded_inputs(cin, cout):
    """subm_conv(compute_dtype=bf16) gives, bitwise, the plain fp32 versions
    on operands rounded beforehand: the forward on bf16(x), bf16(W); the
    dgrad bf16(conv of bf16(g) with flip(bf16(W))^T); dW bf16(sum of
    bf16(x) bf16(g))."""
    x, nbr, w, g = _case(cin, cout, cin + cout)
    tx, tw = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    out = sc.subm_conv(tx, nbr, tw, compute_dtype=BF16)
    out.backward(g)
    assert torch.equal(out.detach(), sc.subm_conv_reference(_rounded(x), nbr, _rounded(w)))
    assert torch.equal(tx.grad, _rounded(sc.subm_conv_dgrad_reference(_rounded(g), nbr, _rounded(w))))
    assert torch.equal(tw.grad, _rounded(sc.subm_conv_wgrad_reference(_rounded(x), nbr, _rounded(g))))
    assert tx.grad.dtype == tw.grad.dtype == torch.float32


def test_bf16_autograd_saves_the_features_as_given():
    """The bf16 autograd function saves the fp32 features the network holds
    anyway (no bf16 copy) and passes the fp32 gradient on as it comes."""
    x, nbr, w, g = _case(16, 16, 1)
    tx, tw = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(lambda t: saved.append(t) or t, lambda t: t):
        out = sc.subm_conv(tx, nbr, tw, compute_dtype=BF16)
    assert [t.dtype for t in saved] == [torch.float32, torch.int32, torch.float32]
    assert saved[0].data_ptr() == tx.data_ptr() and saved[2].data_ptr() == tw.data_ptr()
    seen = []
    orig = sc.subm_conv_dgrad_bf16
    try:
        sc.subm_conv_dgrad_bf16 = lambda grad, n, wt: seen.append(grad) or orig(grad, n, wt)
        out.backward(g)
    finally:
        sc.subm_conv_dgrad_bf16 = orig
    assert seen[0].dtype == torch.float32 and torch.equal(seen[0], g)


def test_bf16_n_tile_is_a_built_wgmma_width():
    """Every N is covered by equal tiles of a width the kernels are built
    for: a multiple of 16, at most 256, one tile up to N = 256."""
    for n in range(1, 700):
        t = sc._n_tile(n)
        tiles = -(-n // t)
        assert t in sc.BF16_N_TILES and t % 16 == 0 and t <= 256
        assert tiles == -(-n // 256) and tiles * t >= n


@pytest.mark.parametrize("net,level,cin,cout,v", FLAGSHIP)
def test_bf16_plans_fit_flagship_shapes(net, level, cin, cout, v):
    """At B = 8 on 132 SMs: the forward (K = Cin, N = Cout), the dgrad
    (K = Cout, N = Cin, never on the 6-channel stem) and the wgrad plans
    fit a block's shared memory and a legal wgmma N, take one N tile (no
    voxel tile gathered twice), and split taps and rows with none empty."""
    b = 8
    for k, n in ((cin, cout), (cout, cin)):
        p = sc.bf16_forward_plan(b, v, k, n, SMS)
        assert 0 < p["smem"] <= sc.BF16_MAX_SMEM
        assert p["n_tile"] >= n and p["n_tile"] in sc.BF16_N_TILES
        assert p["rows"] == (128 if p["n_tile"] <= 128 else 64)
        per = -(-27 // p["splits"])
        assert 1 <= p["splits"] <= 27 and -(-27 // per) == p["splits"]
    w = sc.bf16_wgrad_plan(b, v, cin, cout, SMS)
    assert 0 < w["smem"] <= sc.BF16_MAX_SMEM
    assert w["n_tile"] >= cout and w["n_tile"] in sc.BF16_N_TILES
    assert w["chunk_rows"] % sc.BF16_THREADS == 0
    assert (w["chunks"] - 1) * w["chunk_rows"] < b * v <= w["chunks"] * w["chunk_rows"]
