"""Hash clustering of the committed real cloud on the card: the 16 rotated
copies the benchmark's train cells draw from (angles (k + 1/2) 2 pi / 16),
clustered as two batches of 8 in one call each, against one cloud a call
on the card and on the CPU, every proposal field bitwise.

No JAX here: the card's machine has none (`pytest --noconftest -m cuda`).
"""

import numpy as np
import pytest
import torch

from gapartnet_tpu_torch import entry
from gapartnet_tpu_torch.config import GAPartNetConfig
from gapartnet_tpu_torch.models import grouping as tg


def _rotated_clouds(count=16):
    """(xyz, offsets, sem, valid) numpy arrays of each rotated copy, with the
    ground-truth overrides the train cells cluster, and the capacity
    fields that fit all copies."""
    cfg = GAPartNetConfig()
    d = np.load(entry.BENCH_CLOUD)
    sem, ins = d["sem_labels"].astype(np.int32), d["instance_labels"]
    clouds, fitted = [], []
    for k in range(count):
        xyz = (d["xyz"].astype(np.float64) @ entry.rotation_z((k + 0.5) * 2 * np.pi / count)
               ).astype(np.float32)
        fields, centers = entry._fitted_capacities(cfg, xyz, sem, ins)
        fitted.append(fields)
        clouds.append((xyz, entry._overrides(xyz, centers, ins), sem, (sem > 0) & (ins >= 0)))
    return cfg, clouds, entry.max_fitted(fitted)


def _cluster_per_cloud(cfg, clouds, caps, device):
    return tg.stack_proposals([
        tg.cluster_single(*[torch.as_tensor(a, device=device) for a in c], cfg.ball_query_radius,
                          cfg.min_num_points_per_proposal, cfg.max_proposals, **caps)
        for c in clouds])


def _cluster_batches(cfg, clouds, caps, device, batch=8):
    out = []
    for i in range(0, len(clouds), batch):
        x, o, s, v = (torch.as_tensor(np.stack(a), device=device) for a in zip(*clouds[i:i + batch]))
        out.append(tg.cluster_hash_batch(x, o, s, v, cfg.ball_query_radius,
                                         cfg.min_num_points_per_proposal, cfg.max_proposals, **caps))
    return tg.SampleProposals(*[torch.cat(f) for f in zip(*out)])


@pytest.mark.cuda
def test_card_hash_cluster_batches_match_per_cloud():
    """Two B = 8 calls on the card give every cloud the proposals of its own
    call on the card and on the CPU, with no capacity counter set."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cfg, clouds, fitted = _rotated_clouds()
    caps = dict(hash_node_capacity=fitted["hash_node_capacity"],
                hash_cand_cap=fitted["hash_cand_cap"], hash_max_degree=fitted["hash_max_degree"])
    got = _cluster_batches(cfg, clouds, caps, "cuda")
    torch.cuda.synchronize()
    on_card = _cluster_per_cloud(cfg, clouds, caps, "cuda")
    on_cpu = _cluster_per_cloud(cfg, clouds, caps, "cpu")
    for f in got._fields:
        np.testing.assert_array_equal(getattr(got, f).cpu().numpy(),
                                      getattr(on_card, f).cpu().numpy(), err_msg=f)
        np.testing.assert_array_equal(getattr(got, f).cpu().numpy(),
                                      getattr(on_cpu, f).numpy(), err_msg=f)
    assert (got.num_proposals > 0).all()
    for f in ("ccl_overflow", "ccl_cand_truncated", "num_dropped"):
        assert int(getattr(got, f).sum()) == 0, f
