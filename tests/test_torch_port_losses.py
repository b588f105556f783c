"""Losses, metrics and the IoU: the port against the JAX package.

Values and gradients (with respect to every float input) at
rtol = atol = 1e-5, float32.  The NPCS case includes entries whose orbit
columns tie (types 0-2 pad their orbits with column 0), where the minimum
must split its gradient as jnp.min does; the focal case sets `alpha`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gapartnet_tpu.constants import SYMMETRY_ORBITS as JAX_ORBITS
from gapartnet_tpu.models import losses as JL
from gapartnet_tpu.ops.iou import instance_seg_iou as jax_iou
from gapartnet_tpu_torch import constants as tc
from gapartnet_tpu_torch.models import losses as TL
from gapartnet_tpu_torch.ops.iou import instance_seg_iou

TOL = 1e-5


def _compare(jfn, tfn, floats, ints):
    """Value and gradient of jfn / tfn w.r.t. `floats` (numpy arrays)."""
    jargs = [jnp.asarray(a) for a in floats]
    val, grads = jax.value_and_grad(lambda *a: jfn(*a, *ints), argnums=tuple(range(len(floats))))(*jargs)
    targs = [torch.from_numpy(a.copy()).requires_grad_(True) for a in floats]
    tval = tfn(*targs, *[torch.from_numpy(np.asarray(i)) for i in ints])
    tval.backward()
    np.testing.assert_allclose(float(tval.detach()), float(val), rtol=TOL, atol=TOL)
    for t, g in zip(targs, grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), rtol=TOL, atol=TOL)
    return float(val)


def _sem_case(seed, m=300, c=10):
    rng = np.random.RandomState(seed)
    logits = (rng.randn(m, c) * 2).astype(np.float32)
    labels = rng.randint(0, c, m).astype(np.int32)
    labels[rng.rand(m) < 0.1] = -100
    mask = rng.rand(m) < 0.9
    return logits, labels, mask


def test_orbits_equal():
    np.testing.assert_array_equal(tc.SYMMETRY_ORBITS, JAX_ORBITS)


@pytest.mark.parametrize("alpha", [None, tuple(np.linspace(0.2, 2.0, 10))])
def test_focal_loss(alpha):
    logits, labels, mask = _sem_case(0)
    _compare(lambda x, t, m: JL.focal_loss(x, t, m, gamma=2.0, alpha=alpha),
             lambda x, t, m: TL.focal_loss(x, t, m, gamma=2.0, alpha=alpha),
             [logits], [labels, mask])


@pytest.mark.parametrize("alpha", [None, tuple(np.linspace(0.2, 2.0, 10))])
def test_cross_entropy_branch(alpha):
    """The non-focal branch of models/gapartnet.py:351-368."""
    logits, labels, mask = _sem_case(1)

    def jfn(x, t, m):
        valid = m & (t != -100)
        tt = jnp.clip(t, 0, 9)
        ce = -jnp.take_along_axis(jax.nn.log_softmax(x, -1), tt[:, None], -1)[:, 0]
        if alpha is not None:
            ce = ce * jnp.asarray(alpha, jnp.float32)[tt]
        return jnp.where(valid, ce, 0.0).sum() / jnp.maximum(valid.sum(), 1)

    _compare(jfn, lambda x, t, m: TL.cross_entropy_loss(x, t, m, alpha=alpha),
             [logits], [labels, mask])


def test_dice_loss():
    logits, labels, mask = _sem_case(2)
    labels = np.clip(labels, 0, None)
    _compare(JL.dice_loss, TL.dice_loss, [logits], [labels, mask])


@pytest.mark.parametrize("part", [0, 1])
def test_offset_loss(part):
    rng = np.random.RandomState(3)
    pred = rng.randn(200, 3).astype(np.float32)
    gt = rng.randn(200, 3).astype(np.float32)
    pred[:5] = 0.0      # zero offsets: the guarded norms keep the gradient finite
    gt[5:10] = 0.0
    pred[10:13] = gt[10:13]   # |pred - gt| at 0: jnp.abs differentiates to +1
    valid = rng.rand(200) < 0.8
    _compare(lambda p, g, v: JL.offset_loss(p, g, v)[part],
             lambda p, g, v: TL.offset_loss(p, g, v)[part], [pred, gt], [valid])


def test_sigmoid_bce_and_gt_scores():
    rng = np.random.RandomState(4)
    logits = rng.randn(64).astype(np.float32)
    logits[:3] = 0.0    # the max(x, 0) tie and |x| at 0
    ious = rng.rand(64).astype(np.float32)
    mask = rng.rand(64) < 0.7
    np.testing.assert_allclose(TL.get_gt_scores(torch.from_numpy(ious)).numpy(),
                               np.asarray(JL.get_gt_scores(jnp.asarray(ious))), rtol=TOL, atol=TOL)
    _compare(lambda x, t, m: JL.sigmoid_bce(x, JL.get_gt_scores(t), m),
             lambda x, t, m: TL.sigmoid_bce(x, TL.get_gt_scores(t), m), [logits, ious], [mask])


@pytest.mark.parametrize("exact_gt", [False, True])
def test_npcs_loss(exact_gt):
    """All five symmetry types, entries of several proposals and groups;
    with exact_gt some predictions equal their target, so d2 hits the
    max(d2, 0) and sqrt guards."""
    rng = np.random.RandomState(5)
    e, p = 400, 12
    gt = (rng.rand(e, 3) - 0.5).astype(np.float32)
    preds = rng.rand(e, 3).astype(np.float32)
    if exact_gt:
        preds[:50] = gt[:50] + 0.5
    sym = rng.randint(0, 5, e).astype(np.int32)
    pid = rng.randint(-1, p, e).astype(np.int32)
    mask = rng.rand(e) < 0.85
    val = _compare(lambda a, b, s, q, m: JL.npcs_loss(a, b, s, q, m, p),
                   lambda a, b, s, q, m: TL.npcs_loss(a, b, s, q, m, p),
                   [preds, gt], [sym, pid, mask])
    assert val > 0


def test_npcs_loss_tied_columns_split_gradient():
    """Type 0 pads its orbit with 22 copies of the identity: the minimum over
    columns ties 24 ways, and the gradient must split evenly (jnp.min), not
    go to one column."""
    rng = np.random.RandomState(6)
    e = 40
    gt = (rng.rand(e, 3) - 0.5).astype(np.float32)
    preds = rng.rand(e, 3).astype(np.float32)
    sym = np.zeros(e, np.int32)
    pid = (np.arange(e) // 10).astype(np.int32)
    mask = np.ones(e, bool)
    _compare(lambda a, b, s, q, m: JL.npcs_loss(a, b, s, q, m, 4),
             lambda a, b, s, q, m: TL.npcs_loss(a, b, s, q, m, 4),
             [preds, gt], [sym, pid, mask])


def test_accuracy_and_miou():
    rng = np.random.RandomState(7)
    preds = rng.randint(0, 10, 500).astype(np.int32)
    labels = rng.randint(-1, 10, 500).astype(np.int32)
    mask = rng.rand(500) < 0.9
    t = [torch.from_numpy(a) for a in (preds, labels, mask)]
    j = [jnp.asarray(a) for a in (preds, labels, mask)]
    np.testing.assert_allclose(float(TL.pixel_accuracy(*t)), float(JL.pixel_accuracy(*j)), rtol=1e-6)
    np.testing.assert_allclose(float(TL.mean_iou(*t, 10)), float(JL.mean_iou(*j, 10)), rtol=1e-6)


def test_instance_seg_iou():
    rng = np.random.RandomState(8)
    e, p, i = 600, 16, 8
    pid = rng.randint(-1, p, e).astype(np.int32)
    inst = rng.randint(-1, i + 2, e).astype(np.int32)
    inst[inst < 0] = -100
    mask = rng.rand(e) < 0.9
    psize = np.bincount(pid[mask & (pid >= 0)], minlength=p).astype(np.int32)
    isize = rng.randint(0, 80, i).astype(np.int32)
    want = jax_iou(jnp.asarray(pid), jnp.asarray(inst), jnp.asarray(mask), jnp.asarray(psize),
                   jnp.asarray(isize), num_proposals=p, num_instances=i)
    got = instance_seg_iou(*[torch.from_numpy(a) for a in (pid, inst, mask, psize, isize)], p, i)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.numpy().max() > 0
