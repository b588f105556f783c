"""GAPARTNET_CHECKS invariants: the port's utils/invariants.py against the
JAX package's, and the model's counter checks.

The modes, `check_mode` and each check are held to the JAX module in
"host" mode on the same inputs (both raise, or both pass).  The port has
no jit, so its "jit" mode asserts on the host as "host" does, and
`check_traced` (active in JAX's "jit" mode only) is active in both.  A
clustering forward asserts every capacity counter zero under "host" and
reads none of them under "off", the default.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gapartnet_tpu.data.synthetic import synthetic_batch
from gapartnet_tpu.utils import invariants as jinv
from gapartnet_tpu_torch.config import GAPartNetConfig
from gapartnet_tpu_torch.entry import make_model
from gapartnet_tpu_torch.structures import PointCloudBatch
from gapartnet_tpu_torch.utils import invariants as tinv
from tests.test_torch_port_forward import SMALL


def _outcome(fn):
    try:
        fn()
    except AssertionError as e:
        return f"raised: {e}"
    return "passed"


def test_modes_match_jax():
    assert tinv.MODES == ("off", "host", "jit")
    assert tinv.mode() == "off"
    for mode in tinv.MODES:
        with tinv.check_mode(mode), jinv.check_mode(mode):
            assert tinv.mode() == mode == jinv._MODE
    assert tinv.mode() == "off"
    with pytest.raises(ValueError):
        tinv.set_mode("sometimes")
    with pytest.raises(AssertionError):
        jinv.set_mode("sometimes")
    # check_mode restores the mode after an exception too
    with pytest.raises(RuntimeError):
        with tinv.check_mode("host"):
            raise RuntimeError
    assert tinv.mode() == "off"


@pytest.mark.parametrize("pred", [True, False])
@pytest.mark.parametrize("mode", ["off", "host"])
def test_check_matches_jax(mode, pred):
    with tinv.check_mode(mode), jinv.check_mode(mode):
        want = _outcome(lambda: jinv.check(jnp.asarray(pred), "bad {what}", what="thing"))
        got = _outcome(lambda: tinv.check(torch.tensor(pred), "bad {what}", what="thing"))
        assert got == want
        assert _outcome(lambda: tinv.check(pred, "bad {what}", what="thing")) == want
    assert want == ("passed" if pred or mode == "off" else "raised: bad thing")


@pytest.mark.parametrize("mode", ["off", "host", "jit"])
def test_check_traced_asserts_in_host_and_jit(mode):
    with tinv.check_mode(mode):
        got = _outcome(lambda: tinv.check_traced(torch.tensor(False), "overflow"))
    assert got == ("passed" if mode == "off" else "raised: overflow")


def _voxel_ids(ok):
    mask = np.array([[True, True, False], [True, False, False]])
    ids = np.array([[0, 1, -1], [2, -1, -1]], np.int32)
    if not ok:
        ids[0, 1] = -1
    return ids, mask


def _proposals(ok):
    mask = np.array([[True, True, False, True]])
    ids = np.array([[0, 3, 9, 1]], np.int32)
    if not ok:
        ids[0, 1] = 4
    return ids, mask, 4


@pytest.mark.parametrize("ok", [True, False])
@pytest.mark.parametrize("mode", ["off", "host"])
def test_checks_match_jax(mode, ok):
    ids, mask = _voxel_ids(ok)
    pids, pmask, n = _proposals(ok)
    with tinv.check_mode(mode), jinv.check_mode(mode):
        for jfn, tfn, args in (
            (jinv.check_point_voxel_ids, tinv.check_point_voxel_ids, (ids, mask)),
            (jinv.check_proposal_consistency, tinv.check_proposal_consistency, (pids, pmask)),
        ):
            extra = (n,) if jfn is jinv.check_proposal_consistency else ()
            want = _outcome(lambda: jfn(*(jnp.asarray(a) for a in args), *extra))
            got = _outcome(lambda: tfn(*(torch.from_numpy(a) for a in args), *extra))
            assert got == want
            assert (want == "passed") == (ok or mode == "off")


def _forward(cfg, seed=0):
    d = synthetic_batch(np.random.RandomState(seed), batch_size=2, num_points=512,
                        num_parts=4, max_instances=8)
    inst = d["instance_labels"]
    off = np.where((inst >= 0)[..., None],
                   d["instance_regions"][..., :3] - d["points"][..., :3], 0).astype(np.float32)
    batch = PointCloudBatch(points=torch.from_numpy(d["points"]),
                            point_mask=torch.from_numpy(d["point_mask"]))
    model = make_model(GAPartNetConfig(**cfg), "cpu")

    def run():
        with torch.no_grad():
            return model(batch, do_cluster=True, do_score=True, do_npcs=True,
                         cluster_sem_override=torch.from_numpy(d["sem_labels"].astype(np.int32)),
                         cluster_offset_override=torch.from_numpy(off))

    return run


# SMALL with a voxel capacity of every point at each level and a
# candidate cap of 62: no counter overflows on these clouds
ROOMY = dict(SMALL, level_capacity_divisors=(1, 1, 1), hash_cand_cap=62)


def test_host_mode_raises_on_a_nonzero_counter():
    """Two proposal slots for the synthetic clouds' parts: dropped_proposals
    is the one nonzero counter; "host" and "jit" raise naming it, "off"
    returns the counters."""
    run = _forward(dict(ROOMY, max_proposals=2))
    out = run()
    assert {k for k, v in out.counters.items() if int(v.sum())} == {"dropped_proposals"}
    with tinv.check_mode("host"):
        with pytest.raises(AssertionError, match="capacity overflow in dropped_proposals"):
            run()
    with tinv.check_mode("jit"):
        with pytest.raises(AssertionError, match="capacity overflow"):
            run()


def test_healthy_forward_passes_and_off_reads_nothing(monkeypatch):
    """With every counter zero "host" passes; under "off" the forward makes
    no check call at all (no counter is read, so no host sync)."""
    run = _forward(ROOMY)
    with tinv.check_mode("host"):
        out = run()
    assert all(int(v.sum()) == 0 for v in out.counters.values())
    calls = []
    monkeypatch.setattr(tinv, "check_traced", lambda *a, **k: calls.append(a))
    run()
    assert calls == []
    with tinv.check_mode("host"):
        run()
    assert len(calls) == len(out.counters)
