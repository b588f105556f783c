"""bf16 conv compute (`conv_compute_dtype="bfloat16"`): the port against the
JAX package's bf16 path.

The JAX reference runs jitted on the CPU through its XLA path (not Pallas),
compiled with `xla_allow_excess_precision` off: by default XLA's CPU
compiler may drop an f32 -> bf16 -> f32 round trip (a bf16 conv output
widened to f32 comes back unrounded), so the program would not round
where it says it does.  With the flag off it rounds at the points the port
reproduces (ops/sparse_conv.py:286-318, 375-377; models/dense_unet.py:48-94,
act_dtype; models/gapartnet.py:527-533, 642-646, 699-703).

Tolerances, and why:

  * one conv, forward: bf16 products are exact in fp32, so only the order
    of the fp32 sums differs: 1e-5 of max|ref|;
  * its VJP (dgrad and dW rounded to bf16): equal wherever the two fp32
    sums round to the same bf16; elsewhere one bf16 ulp apart, and only
    where the exact (float64) sum lies within 1e-5 of its scale of a bf16
    rounding midpoint;
  * the dense proposal UNet (eval with act_dtype, and train): a bf16
    rounding of an activation flips where the two fp32 values straddle a
    bf16 midpoint, which an fp32 sum in another order can cause; at most
    1e-3 of the elements may differ, by at most 2^-7 of the output's scale;
  * the whole network: a bf16 network is chaotic at the level of fp32
    rounding.  One fp32 ulp in a BatchNorm output flips a bf16 rounding
    further on, and the flip grows through the layers below (training's
    batch statistics at the small coarse levels amplify it most).  So
    whole-network floats are held as chip_smoke.py phase 6 holds the card:
    max|port - jax| <= TOL * scale + 2 * max_p max|port_p - port|, where
    port_p is the port with every BatchNorm output moved by a seeded
    +-1 fp32 ulp (what another fp32 rounding does).  At eval, where the
    cascade is mild, the mean distance from JAX bf16 must also be at most a
    tenth of JAX bf16's own mean distance from JAX f32 on the same output,
    which fails a port that ran f32 or rounded elsewhere; in the train step
    the cascade reaches that distance (up to 0.8 of it in the gradients), so
    rounding placement is held by the single-conv and dense-UNet tests.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gapartnet_tpu.data.synthetic import synthetic_batch
from gapartnet_tpu.models.dense_unet import DenseProposalUNet as JaxUNet
from gapartnet_tpu.models.gapartnet import GAPartNet as JaxModel
from gapartnet_tpu.models.gapartnet import GAPartNetConfig as JaxConfig
from gapartnet_tpu.ops.sparse_conv import subm_conv_apply
from gapartnet_tpu.structures import PointCloudBatch as JaxBatch
from gapartnet_tpu.train import loop as jloop
from gapartnet_tpu_torch.config import GAPartNetConfig
from gapartnet_tpu_torch.models.dense_unet import ProposalUNet
from gapartnet_tpu_torch.models.gapartnet import GAPartNet
from gapartnet_tpu_torch.models.norm import bn_ulp_probe
from gapartnet_tpu_torch.ops import subm_conv as sc
from gapartnet_tpu_torch.structures import PointCloudBatch
from gapartnet_tpu_torch.train import loop as tloop
from gapartnet_tpu_torch.utils import profiling as tprofiling
from gapartnet_tpu_torch.weights import params_from_jax
from tests.test_torch_port_dense_unet import _grid as dense_grid
from tests.test_torch_port_forward import SMALL, _random_stats
from tests.test_torch_port_subm_conv import _grid, _launched
from tests.test_torch_port_train import LOSSES, jax_jitter, port_step

BF16 = torch.bfloat16
CONV_RTOL = 1e-5
MIDPOINT_RTOL = 1e-5
FLIP_SHARE = 1e-3
FLIP_SIZE = 2.0 ** -7
NET_TOL = 1e-4
KINK_FACTOR = 2.0
GRAD_RTOL = 1e-3
GRAD_FLOOR = 1e-4
MEAN_SHARE = 0.1
PROBES = (11, 12)
TRAIN_PROBES = (11, 12, 13, 14)


def jit_exact(fn):
    """jax.jit with the program's bf16 roundings kept (see the module
    docstring)."""
    return jax.jit(fn, compiler_options={"xla_allow_excess_precision": False})


def bf16_ulp(x: np.ndarray) -> np.ndarray:
    """The spacing of bf16 numbers at |x| (8 significant bits)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126)))
    return 2.0 ** (e - 7)


def _conv_case(cin, seed, cout=12):
    """Ragged V (300 capacity, 250 / 180 voxels), absent taps (the padded
    rows have none), features, weights and an output gradient."""
    rng = np.random.RandomState(seed)
    _, nbr = _grid(seed)
    b, _, v = nbr.shape
    x = rng.randn(b, v, cin).astype(np.float32)
    w = (rng.randn(27, cin, cout) / np.sqrt(27 * cin)).astype(np.float32)
    g = rng.randn(b, v, cout).astype(np.float32)
    return x, nbr, w, g


@pytest.mark.parametrize("cin", [5, 6, 16, 40])
def test_bf16_conv_forward_matches_jax(cin):
    x, nbr, w, _ = _conv_case(cin, cin)
    want = np.asarray(jit_exact(lambda a, n, c: subm_conv_apply(
        a, n, c, compute_dtype=jnp.bfloat16))(x, nbr, w))
    with tprofiling.record() as rec:
        got = sc.subm_conv(torch.from_numpy(x), torch.from_numpy(nbr), torch.from_numpy(w),
                           compute_dtype=BF16)
    assert not any(_launched(rec).values()), "the CPU path launches nothing"
    assert got.dtype == torch.float32 and got.shape == want.shape
    scale = np.abs(want).max()
    assert np.abs(got.numpy() - want).max() <= CONV_RTOL * scale
    # the bf16 result is not the f32 conv's
    f32 = sc.subm_conv_reference(torch.from_numpy(x), torch.from_numpy(nbr), torch.from_numpy(w))
    assert np.abs(f32.numpy() - want).max() > 100 * CONV_RTOL * scale


def _check_rounded(name, got, want, exact):
    """got and want are fp32 sums rounded to bf16: equal, or one bf16 ulp
    apart where the exact sum lies at a bf16 rounding midpoint (to within
    MIDPOINT_RTOL of the scale).  Returns the count that differ."""
    assert np.array_equal(got, got.astype(jnp.bfloat16).astype(np.float32)), f"{name}: not bf16"
    diff = got != want
    n = int(diff.sum())
    print(f"{name}: {n} of {got.size} differ by one bf16 ulp")
    if n:
        # the smaller spacing of the two: they may straddle a power of two
        ulp = np.minimum(bf16_ulp(want[diff]), bf16_ulp(got[diff]))
        np.testing.assert_allclose(np.abs(got[diff] - want[diff]), ulp, rtol=0, atol=0,
                                   err_msg=f"{name}: a difference other than one ulp")
        e = exact[diff]
        mid = (np.floor(e / bf16_ulp(e)) + 0.5) * bf16_ulp(e)
        assert np.abs(e - mid).max() <= MIDPOINT_RTOL * np.abs(exact).max(), (
            f"{name}: a differing value is not at a rounding midpoint")
    return n


@pytest.mark.parametrize("cin", [5, 6, 16, 40])
def test_bf16_vjp_matches_jax(cin):
    """dgrad and dW of the bf16 conv against jax.vjp, rounding points
    included: the cotangent, the dgrad and dW are rounded to bf16."""
    x, nbr, w, g = _conv_case(cin, 100 + cin)

    def vjp(a, n, c, ct):
        _, f = jax.vjp(lambda p, q: subm_conv_apply(p, n, q, compute_dtype=jnp.bfloat16), a, c)
        return f(ct)

    want_x, want_w = (np.asarray(t) for t in jit_exact(vjp)(x, nbr, w, g))
    tx = torch.from_numpy(x).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    sc.subm_conv(tx, torch.from_numpy(nbr), tw, compute_dtype=BF16).backward(torch.from_numpy(g))
    assert tx.grad.dtype == tw.grad.dtype == torch.float32
    r = [sc.round_bf16(torch.from_numpy(t)).double() for t in (x, w, g)]
    exact_x = sc.subm_conv_dgrad_reference(r[2], torch.from_numpy(nbr), r[1]).numpy()
    exact_w = sc.subm_conv_wgrad_reference(r[0], torch.from_numpy(nbr), r[2]).numpy()
    _check_rounded(f"dgrad Cin {cin}", tx.grad.numpy(), want_x, exact_x)
    _check_rounded(f"dW Cin {cin}", tw.grad.numpy(), want_w, exact_w)


def test_bf16_wrappers_take_bf16_and_pad():
    """The bf16 wrappers take float32 or bfloat16 operands, rows of any
    width, and round inside (the kernels round as they stage, the plain
    versions here): bfloat16 and float32 inputs give bitwise-equal results;
    rows of 6 channels need no padded copy (there is no operand-copy
    helper; the kernels pad to 16 channels in shared memory); float64 and
    float16 raise."""
    assert not hasattr(sc, "bf16_rows")
    for cin in (6, 16):
        x, nbr, w, g = _conv_case(cin, 3)
        tx, tn, tw, tg = (torch.from_numpy(t) for t in (x, nbr, w, g))
        for fwd in (sc.subm_conv_forward_bf16(tx.to(BF16), tn, tw.to(BF16)),
                    sc.subm_conv_forward_bf16(tx.to(BF16), tn, tw),
                    sc.subm_conv_forward_bf16(tx, tn, tw.to(BF16))):
            torch.testing.assert_close(fwd, sc.subm_conv_forward_bf16(tx, tn, tw), rtol=0, atol=0)
        torch.testing.assert_close(sc.subm_conv_wgrad_bf16(tx.to(BF16), tn, tg.to(BF16)),
                                   sc.subm_conv_wgrad_bf16(tx, tn, tg), rtol=0, atol=0)
        torch.testing.assert_close(sc.subm_conv_dgrad_bf16(tg.to(BF16), tn, tw),
                                   sc.subm_conv_dgrad_bf16(tg, tn, tw), rtol=0, atol=0)
        assert sc.bf16_forward_plan(2, 300, cin, 12, 132)["n_tile"] == 16
    with pytest.raises(TypeError):
        sc.subm_conv_forward_bf16(tx.double(), tn, tw)
    with pytest.raises(TypeError):
        sc.subm_conv_forward_bf16(tx.half(), tn, tw)
    with pytest.raises(TypeError):
        sc.subm_conv_wgrad_bf16(tx, tn, tg.double())
    with pytest.raises(ValueError):
        sc.subm_conv(tx, tn, tw, compute_dtype=torch.float16)


def _dense_variables(jm, x, occ, rng):
    v = jax.jit(lambda a, o: jm.init(jax.random.PRNGKey(0), a, o, False))(x, occ)
    v = jax.tree_util.tree_map(np.asarray, v)
    return {"params": v["params"], "batch_stats": _random_stats(v["batch_stats"], rng)}


def _check_flips(name, got, want):
    """At most FLIP_SHARE of the elements differ, each by at most FLIP_SIZE
    of the scale (a bf16 rounding that flipped)."""
    d = np.abs(got - want)
    scale = np.abs(want).max()
    n = int((d > 0).sum())
    print(f"{name}: {n} of {d.size} differ, max|d| / scale {d.max() / scale:.2e}")
    assert n <= FLIP_SHARE * d.size, name
    assert d.max() <= FLIP_SIZE * scale, name


@pytest.mark.parametrize("train", [False, True])
def test_bf16_dense_unet_matches_jax(train):
    """DenseProposalUNet at bf16: eval keeps activations in bf16
    (act_dtype), train does not (AD needs f32) and normalizes with batch
    statistics; both take the grid in bf16, as the model stores it.  The
    parameter gradients are held too: the dense convs round the output
    gradient, dgrad and wgrad to bf16 as the JAX `_conv` does.  The eval
    output is held to rounding flips; the train output, whose batch
    statistics carry a flip on through every layer, and the gradients to
    the ulp probes' allowance; both outputs to a tenth of the f32 UNet's
    mean distance."""
    rng = np.random.RandomState(4)
    x, occ = dense_grid(rng, g=3, s=8, c=8)
    xb = np.array(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
    channels = (8, 16)
    act = None if train else jnp.bfloat16
    jm = JaxUNet(channels, 2, compute_dtype=jnp.bfloat16, act_dtype=act)
    variables = _dense_variables(jm, x, occ, rng)
    ct = rng.randn(3, 8, 8, 8, 8).astype(np.float32)

    def jf(params, stats, a, o):
        y, _ = jm.apply({"params": params, "batch_stats": stats}, a.astype(jnp.bfloat16), o, train,
                        mutable=["batch_stats"])
        y = y.astype(jnp.float32)
        return jnp.sum(y * ct), y

    (_, want), jgrads = jit_exact(jax.value_and_grad(jf, has_aux=True))(
        variables["params"], variables["batch_stats"], x, occ)
    want = np.asarray(want)
    want_g = params_from_jax({"params": jax.tree_util.tree_map(np.asarray, jgrads)})

    def run(dtype=BF16):
        tm = ProposalUNet(channels, 2, compute_dtype=dtype)
        tm.load_state_dict(params_from_jax(variables), strict=True)
        tm.train(train)
        y = tm.dense(torch.from_numpy(xb).to(dtype or torch.float32), torch.from_numpy(occ),
                     None if train else dtype)
        assert y.dtype == (torch.float32 if train or dtype is None else BF16)
        (y.float() * torch.from_numpy(ct)).sum().backward()
        return y.detach().float().numpy(), {k: p.grad.numpy() for k, p in tm.named_parameters()}

    got, grads = run()
    assert (got[~occ] == 0).all() and np.abs(got[occ]).max() > 0
    f32, _ = run(None)
    probes = []
    for seed in TRAIN_PROBES:
        with bn_ulp_probe(seed):
            probes.append(run())
    if train:
        _check_net_float("dense UNet output", got, want, [p[0] for p in probes], f32=f32)
    else:
        _check_flips("dense UNet output", got, want)
        assert np.abs(got - want).mean() <= MEAN_SHARE * np.abs(f32 - want).mean()
    for k, g in grads.items():
        _check_net_float(f"grad {k}", g, want_g[k].numpy(), [p[1][k] for p in probes],
                         tol=GRAD_RTOL)


def _batch(labelled):
    d = synthetic_batch(np.random.RandomState(0), batch_size=2, num_points=512,
                        num_parts=4, max_instances=8)
    ids = d.pop("pc_ids")
    inst = d["instance_labels"]
    off = np.where((inst >= 0)[..., None],
                   d["instance_regions"][..., :3] - d["points"][..., :3], 0).astype(np.float32)
    sem = d["sem_labels"].astype(np.int32)
    if labelled:
        return (JaxBatch(**{k: jnp.asarray(v) for k, v in d.items()}, pc_ids=ids),
                PointCloudBatch.from_numpy(d, "cpu"), sem, off)
    return (JaxBatch(points=jnp.asarray(d["points"]), point_mask=jnp.asarray(d["point_mask"])),
            PointCloudBatch(points=torch.from_numpy(d["points"]),
                            point_mask=torch.from_numpy(d["point_mask"])), sem, off)


def _jax_variables(jm, jbatch):
    v = jax.jit(lambda b: jm.init(
        {"params": jax.random.PRNGKey(0), "proposal_jitter": jax.random.PRNGKey(1)},
        b, train=False, do_cluster=True, do_score=True, do_npcs=True))(jbatch)
    v = jax.tree_util.tree_map(np.asarray, v)
    return {"params": v["params"],
            "batch_stats": _random_stats(v["batch_stats"], np.random.RandomState(5))}


def _port_model(cfg, variables):
    tm = GAPartNet(cfg)
    tm.load_state_dict(params_from_jax(variables), strict=True)
    return tm


def _check_net_float(name, got, want, probes, f32=None, tol=NET_TOL, floor=0.0):
    """max|got - want| <= tol * scale + KINK_FACTOR * (the probes' largest
    move), scale = max(max|want|, floor); with `f32` (JAX's f32 output) the
    mean distance from JAX bf16 is at most MEAN_SHARE of JAX bf16's mean
    distance from it."""
    scale = max(float(np.abs(want).max()), floor, 1e-30)
    err = float(np.abs(got - want).max())
    own = max(float(np.abs(p - got).max()) for p in probes)
    msg = f"{name}: max|d| / scale {err / scale:.2e}, probes {own / scale:.2e}"
    if f32 is not None:
        ratio = float(np.abs(got - want).mean()) / float(np.abs(want - f32).mean())
        msg += f", mean|d| / mean|jax bf16 - jax f32| {ratio:.4f}"
        assert ratio <= MEAN_SHARE, msg
    print(msg)
    assert err <= tol * scale + KINK_FACTOR * own, msg


@pytest.mark.parametrize("impl", ["dense", "sparse"])
def test_bf16_eval_forward_matches_jax(impl):
    """The SMALL eval forward at bf16 under the clustering overrides, the
    proposal UNets dense (eval's own) or sparse."""
    jbatch, tbatch, sem, off = _batch(labelled=False)
    kw = dict(SMALL, proposal_conv_impl=impl)
    flags = dict(do_cluster=True, do_score=True, do_npcs=True)
    outs = {}
    for dtype in ("float32", "bfloat16"):
        jm = JaxModel(JaxConfig(**kw, conv_compute_dtype=dtype))
        if dtype == "float32":
            variables = _jax_variables(jm, jbatch)
        outs[dtype] = jit_exact(lambda v, b, cs, co: jm.apply(
            v, b, train=False, **flags, cluster_sem_override=cs, cluster_offset_override=co))(
                variables, jbatch, jnp.asarray(sem), jnp.asarray(off))
    jo, jf = outs["bfloat16"], outs["float32"]
    tm = _port_model(GAPartNetConfig(**kw, conv_compute_dtype="bfloat16"), variables).eval()

    def run():
        with torch.no_grad():
            return tm(tbatch, **flags, cluster_sem_override=torch.from_numpy(sem),
                      cluster_offset_override=torch.from_numpy(off))

    to = run()
    probes = []
    for seed in PROBES:
        with bn_ulp_probe(seed):
            probes.append(run())

    for f in jo.proposals._fields:
        np.testing.assert_array_equal(getattr(to.proposals, f).numpy(),
                                      np.asarray(getattr(jo.proposals, f)), err_msg=f)
    for k, v in jo.counters.items():
        np.testing.assert_array_equal(to.counters[k].numpy(), np.asarray(v), err_msg=k)
    assert (np.asarray(jo.proposals.num_proposals) > 0).all()
    # sem_preds: equal outside near-ties of JAX's two largest logits
    logits = np.asarray(jo.sem_logits)
    flip = to.sem_preds.numpy() != np.asarray(jo.sem_preds)
    top2 = np.sort(logits[flip], axis=-1)[:, -2:]
    assert (top2[:, 1] - top2[:, 0] <= 2 * NET_TOL * np.abs(logits).max()).all()
    print(f"sem_preds differing at near-ties: {int(flip.sum())}")
    np.testing.assert_array_equal(to.proposal_sem.numpy(), np.asarray(jo.proposal_sem))
    for name in ("sem_logits", "offset_preds", "score_logits", "npcs_preds"):
        got = getattr(to, name).numpy()
        assert got.dtype == np.float32 and got.shape == np.asarray(getattr(jo, name)).shape
        _check_net_float(name, got, np.asarray(getattr(jo, name)),
                         [getattr(p, name).numpy() for p in probes],
                         np.asarray(getattr(jf, name)))


def test_bf16_train_step_matches_jax():
    """One SMALL train step at bf16 (all stages, the proposal UNets sparse,
    under the clustering overrides) against jax.value_and_grad of
    make_train_step's loss: integers exactly; the five losses, every
    parameter's gradient (max|ref| floored at GRAD_FLOOR of the largest, as
    in test_torch_port_train.py) and the updated batch statistics within
    NET_TOL / GRAD_RTOL of scale plus twice what the ulp probes move them;
    then one Adam step on the port's bf16 gradients against optax."""
    jbatch, tbatch, sem, off = _batch(labelled=True)
    cfg = dict(SMALL, conv_compute_dtype="bfloat16")
    jm = JaxModel(JaxConfig(**cfg))
    variables = _jax_variables(jm, jbatch)
    flags = dict(do_cluster=True, do_score=True, do_npcs=True)
    key = jax.random.PRNGKey(3)

    def loss_fn(params, stats, b, k, cs, co):
        out, mutated = jm.apply({"params": params, "batch_stats": stats}, b, train=True, **flags,
                                rngs={"proposal_jitter": k}, mutable=["batch_stats"],
                                cluster_sem_override=cs, cluster_offset_override=co)
        return out.total_loss, (out, mutated["batch_stats"])

    (_, (jo, new_bs)), grads = jit_exact(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"], variables["batch_stats"], jbatch, key, jnp.asarray(sem),
        jnp.asarray(off))
    jitter = jax_jitter(jm, variables, jbatch, key)

    def step():
        tm = _port_model(GAPartNetConfig(**cfg), variables)
        return tm, port_step(tm, tbatch, jitter, flags, sem, off)

    tm, to = step()
    probes = []
    for seed in TRAIN_PROBES:
        with bn_ulp_probe(seed):
            probes.append(step())

    for f in jo.proposals._fields:
        np.testing.assert_array_equal(getattr(to.proposals, f).numpy(),
                                      np.asarray(getattr(jo.proposals, f)), err_msg=f)
    np.testing.assert_array_equal(to.proposal_sem.numpy(), np.asarray(jo.proposal_sem))
    for k, v in jo.counters.items():
        np.testing.assert_array_equal(to.counters[k].numpy(), np.asarray(v), err_msg=k)
    np.testing.assert_array_equal(to.ious.numpy(), np.asarray(jo.ious))
    flip = to.sem_preds.numpy() != np.asarray(jo.sem_preds)
    logits = np.asarray(jo.sem_logits)
    top2 = np.sort(logits[flip], axis=-1)[:, -2:]
    gap = float(np.abs(to.sem_logits.detach().numpy() - logits).max())
    assert (top2[:, 1] - top2[:, 0] <= 2 * gap).all(), "sem_preds differ beyond near-ties"
    print(f"sem_preds differing at near-ties: {int(flip.sum())}")
    same = ~flip[np.arange(2)[:, None], np.asarray(jo.proposals.entry_point).clip(0)]
    np.testing.assert_array_equal(to.npcs_valid.numpy()[same], np.asarray(jo.npcs_valid)[same])

    for k in LOSSES:
        _check_net_float(k, np.float32(getattr(to, k).detach()), np.float32(getattr(jo, k)),
                         [np.float32(getattr(p, k).detach()) for _, p in probes])
    want = params_from_jax({"params": jax.tree_util.tree_map(np.asarray, grads)})
    assert set(want) == {k for k, _ in tm.named_parameters()}
    top = max(float(w.abs().max()) for w in want.values())

    def grad(model, name):
        p = dict(model.named_parameters())[name]
        return (torch.zeros_like(p) if p.grad is None else p.grad).numpy()

    for name, w in want.items():
        _check_net_float(f"grad {name}", grad(tm, name), w.numpy(),
                         [grad(pm, name) for pm, _ in probes], tol=GRAD_RTOL,
                         floor=GRAD_FLOOR * top)
    want_bs = params_from_jax({"params": {}, "batch_stats": jax.tree_util.tree_map(np.asarray, new_bs)})
    sd = tm.state_dict()
    for name, w in want_bs.items():
        _check_net_float(name, sd[name].numpy(), w.numpy(),
                         [pm.state_dict()[name].numpy() for pm, _ in probes])

    # Adam on these bf16 gradients against optax on the same numbers
    grads_np = {k: p.grad.numpy().copy() for k, p in tm.named_parameters() if p.grad is not None}
    params_np = {k: p.detach().numpy().copy() for k, p in tm.named_parameters() if k in grads_np}
    tx = jloop.adam(1e-3)
    jp = {k: jnp.asarray(v) for k, v in params_np.items()}
    updates, _ = tx.update({k: jnp.asarray(v) for k, v in grads_np.items()}, tx.init(jp), jp)
    import optax

    jp = optax.apply_updates(jp, updates)
    opt = tloop.adam([(k, p) for k, p in tm.named_parameters() if k in grads_np], 1e-3)
    opt.step()
    for k, p in tm.named_parameters():
        if k in grads_np:
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]), rtol=1e-6,
                                       atol=1e-6, err_msg=k)


def test_bf16_config_reaches_the_modules():
    """conv_compute_dtype="bfloat16" builds bf16 convs everywhere the JAX
    package uses the compute dtype; float32 builds none; other values are
    refused."""
    m = GAPartNet(GAPartNetConfig(**SMALL, conv_compute_dtype="bfloat16"))
    convs = [mod for name, mod in m.named_modules() if name.endswith(("conv1", "conv2", "stem_conv"))
             and mod is not None]
    assert convs and all(c.compute_dtype == BF16 for c in convs)
    assert m.score_unet.compute_dtype == m.npcs_unet.compute_dtype == BF16
    f = GAPartNet(GAPartNetConfig(**SMALL))
    assert all(getattr(mod, "compute_dtype", None) is None for mod in f.modules())
    with pytest.raises(ValueError):
        GAPartNet(GAPartNetConfig(**SMALL, conv_compute_dtype="float16"))
    with pytest.raises(ValueError):
        m.with_config(dataclasses.replace(m.cfg, conv_compute_dtype="float32"))


def test_bf16_entry_points():
    """The trainer's YAML key builds a bf16 model; bench_cloud_setup and
    train_setup carry bench.py's bf16 config; GAPartNetInference at bf16
    runs predict at SMALL size."""
    from gapartnet_tpu.data.synthetic import synthetic_cloud
    from gapartnet_tpu_torch.entry import bench_cloud_setup, make_model
    from gapartnet_tpu_torch.infer.api import GAPartNetInference
    from gapartnet_tpu_torch.train.config import config_from_yaml_dict

    cfg = config_from_yaml_dict({"model": {"init_args": {
        "conv_compute_dtype": "bfloat16", "backbone_cfg": {"channels": [8, 16]}}}})
    assert cfg.model.conv_compute_dtype == "bfloat16"
    model = make_model(cfg.model, "cpu")
    assert model.backbone.stem_conv.compute_dtype == BF16
    bcfg, batch, _, _ = bench_cloud_setup(GAPartNetConfig(conv_compute_dtype="bfloat16"),
                                          device="cpu")
    assert bcfg.conv_compute_dtype == "bfloat16" and batch.batch_size == 1

    inf = GAPartNetInference(GAPartNetConfig(**SMALL, conv_compute_dtype="bfloat16"), seed=0,
                             auto_capacity=True, device="cpu")
    c = synthetic_cloud(np.random.RandomState(2), num_points=SMALL["max_points"], num_parts=4)
    with tprofiling.record() as rec:
        res = inf.predict(c["points"], ransac_iters=20)
    assert not any(_launched(rec).values())
    assert res.sem_preds.shape == (SMALL["max_points"],)
    assert np.isfinite(res.npcs_map).all() and np.isfinite(res.proposal_scores).all()
    assert inf.model.backbone.stem_conv.compute_dtype == BF16
