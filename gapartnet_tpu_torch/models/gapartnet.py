"""GAPartNet eval forward: backbone + semantic / offset / score / NPCS heads.

Counterpart of the `GAPartNet` module of models/gapartnet.py in eval mode
(train=False) with the dense proposal path.  Three stage flags select the
work as in the JAX package: `do_cluster`, `do_score`, `do_npcs`.  Losses,
IoUs against ground truth, the sparse proposal path and training belong to
later slices; the output carries None for them.

Module and parameter names follow the flax tree (weights.params_from_jax
maps one onto the other).
"""

import dataclasses
from typing import Dict, Optional

import torch
from torch import nn

from gapartnet_tpu_torch.config import GAPartNetConfig
from gapartnet_tpu_torch.models.backbone import SparseUNet
from gapartnet_tpu_torch.models.dense_unet import DenseProposalUNet
from gapartnet_tpu_torch.models.grouping import (
    SampleProposals,
    cluster_single,
    segmented_dense_voxelize_single,
    stack_proposals,
)
from gapartnet_tpu_torch.models.norm import MaskedBatchNorm
from gapartnet_tpu_torch.ops.segment import segment_mean, segment_min
from gapartnet_tpu_torch.ops.sparse_conv import build_hierarchy
from gapartnet_tpu_torch.ops.voxelize import voxelize_single
from gapartnet_tpu_torch.structures import PointCloudBatch


@dataclasses.dataclass
class ModelOutput:
    sem_logits: torch.Tensor                      # (B, N, C)
    sem_preds: torch.Tensor                       # (B, N) int32
    offset_preds: torch.Tensor                    # (B, N, 3)
    pc_features: torch.Tensor                     # (B, N, fea)
    proposals: Optional[SampleProposals] = None   # batched (leading B)
    proposal_sem: Optional[torch.Tensor] = None   # (B, P)
    score_logits: Optional[torch.Tensor] = None   # (B, P)
    score_preds: Optional[torch.Tensor] = None    # (B, P)
    ious: Optional[torch.Tensor] = None           # training / AP slice
    npcs_preds: Optional[torch.Tensor] = None     # (B, 2N, 3)
    npcs_valid: Optional[torch.Tensor] = None     # training slice
    # dense proposal-grid site of each entry (B, 2N), -1 = dropped
    entry_site: Optional[torch.Tensor] = None
    # capacity-overflow counters, (B,) int32 each; all zero in healthy runs
    counters: Optional[Dict[str, torch.Tensor]] = None
    loss_sem_seg: Optional[torch.Tensor] = None
    loss_offset_dist: Optional[torch.Tensor] = None
    loss_offset_dir: Optional[torch.Tensor] = None
    loss_prop_score: Optional[torch.Tensor] = None
    loss_prop_npcs: Optional[torch.Tensor] = None


def prepare_input_grid(points: torch.Tensor, point_mask: torch.Tensor, cfg: GAPartNetConfig):
    """Voxelize each sample (1 cm voxels over its own bbox +- 1e-4).

    Returns (voxel_keys (B, V), voxel_feats (B, V, 6), num_voxels (B,),
    pc_voxel_id (B, N))."""
    outs = []
    for pts, mask in zip(points, point_mask):
        xyz = pts[:, :3]
        big = torch.tensor(1e9, dtype=xyz.dtype, device=xyz.device)
        rmin = torch.where(mask[:, None], xyz, big).amin(dim=0) - 1e-4
        rmax = torch.where(mask[:, None], xyz, -big).amax(dim=0) + 1e-4
        res = voxelize_single(xyz, pts, cfg.voxel_size, rmin, rmax, point_mask=mask)
        outs.append((res.voxel_keys, res.voxel_features, res.num_voxels, res.pc_voxel_id))
    return tuple(torch.stack(list(f)) for f in zip(*outs))


def _gather_rows(x: torch.Tensor, idx: torch.Tensor, ok: torch.Tensor) -> torch.Tensor:
    """x (B, R, ...) gathered at idx (B, Q) -> (B, Q, ...), zeros where ~ok."""
    bidx = torch.arange(x.shape[0], device=x.device)[:, None]
    g = x[bidx, idx.clamp(min=0).long()]
    ok = ok.reshape(ok.shape + (1,) * (g.ndim - ok.ndim))
    return torch.where(ok, g, torch.zeros((), dtype=g.dtype, device=g.device))


class GAPartNet(nn.Module):
    """The full network, eval forward.  Labels in the batch are optional."""

    def __init__(self, cfg: GAPartNetConfig):
        super().__init__()
        if cfg.backbone_type != "SparseUNet":
            raise NotImplementedError(f"backbone {cfg.backbone_type} is not ported")
        if cfg.clustering_impl != "hash":
            raise NotImplementedError(f"clustering {cfg.clustering_impl} is not ported")
        if cfg.proposal_conv_impl not in ("auto", "dense"):
            raise NotImplementedError("only the dense proposal path is ported")
        if cfg.conv_compute_dtype != "float32":
            raise NotImplementedError("only float32 conv compute is ported")
        self.cfg = cfg
        c = cfg.num_part_classes
        fea = cfg.channels[0]
        self.backbone = SparseUNet(cfg.in_channels, cfg.channels, cfg.block_repeat)
        self.sem_seg_head = nn.Linear(fea, c)
        self.offset_mlp0 = nn.Linear(fea, fea)
        self.offset_bn = MaskedBatchNorm(fea)
        self.offset_mlp1 = nn.Linear(fea, 3)
        self.score_unet = DenseProposalUNet(cfg.channels[:2], cfg.block_repeat)
        self.score_head = nn.Linear(fea, c - 1)
        self.npcs_unet = DenseProposalUNet(cfg.channels[:2], cfg.block_repeat)
        self.npcs_head = nn.Linear(fea, 3 * (c - 1))

    @torch.no_grad()
    def forward(
        self,
        batch: PointCloudBatch,
        do_cluster: bool = False,
        do_score: bool = False,
        do_npcs: bool = False,
        cluster_sem_override: Optional[torch.Tensor] = None,
        cluster_offset_override: Optional[torch.Tensor] = None,
    ) -> ModelOutput:
        """cluster_sem_override / cluster_offset_override drive clustering
        with supplied labels and offsets instead of the heads' outputs (the
        bench's trained-operating-point load); the heads still run."""
        if self.training:
            raise NotImplementedError("the port has the eval forward only; call .eval()")
        cfg = self.cfg
        c = cfg.num_part_classes
        points, point_mask = batch.points, batch.point_mask
        b, n = point_mask.shape
        dev = points.device
        i32 = torch.int32
        pt_xyz = points[..., :3]
        fea = cfg.channels[0]
        counters = {}

        # input grid + backbone
        keys, vfeats, nvox, pc_voxel_id = prepare_input_grid(points, point_mask, cfg)
        hierarchy = build_hierarchy(
            keys, nvox, cfg.input_capacities(), extent=cfg.input_grid_extent
        )
        counters["backbone_voxels_dropped"] = sum(ds.num_dropped for ds in hierarchy.downsamples)
        voxel_out = self.backbone(vfeats.contiguous(), hierarchy)
        pc_feats = _gather_rows(voxel_out, pc_voxel_id, pc_voxel_id >= 0)   # (B, N, fea)

        # semantic head
        sem_logits = self.sem_seg_head(pc_feats)
        sem_preds = torch.argmax(sem_logits, dim=-1).to(i32)

        # offset head
        x = torch.relu(self.offset_bn(self.offset_mlp0(pc_feats), point_mask))
        offset_preds = self.offset_mlp1(x)

        out = ModelOutput(
            sem_logits=sem_logits, sem_preds=sem_preds, offset_preds=offset_preds,
            pc_features=pc_feats, counters=counters,
        )
        if not do_cluster:
            return out

        # dual-set clustering
        cluster_sem = sem_preds if cluster_sem_override is None else cluster_sem_override
        cluster_valid = (cluster_sem > 0) & point_mask
        if batch.sem_labels is not None and batch.instance_labels is not None:
            cluster_valid = cluster_valid & (batch.instance_labels >= 0)
        offs = offset_preds if cluster_offset_override is None else cluster_offset_override
        node_cap = min(cfg.hash_node_capacity, cfg.max_points) if cfg.hash_node_capacity else 0
        prop = stack_proposals([
            cluster_single(
                pt_xyz[i], offs[i], cluster_sem[i], cluster_valid[i],
                cfg.ball_query_radius, cfg.min_num_points_per_proposal, cfg.max_proposals,
                hash_node_capacity=node_cap, hash_cand_cap=cfg.hash_cand_cap,
                hash_max_degree=cfg.hash_max_degree,
            )
            for i in range(b)
        ])

        # eval placement jitter is the cube centre
        rand = torch.full((3,), 0.5, dtype=torch.float32, device=dev)
        entry_feats = _gather_rows(pc_feats, prop.entry_point, prop.entry_mask)
        s = int(cfg.score_fullscale)
        p_cap = cfg.max_proposals
        entry_cell = torch.stack([
            segmented_dense_voxelize_single(
                pt_xyz[i], SampleProposals(*[f[i] for f in prop]), rand, rand, p_cap,
                cfg.score_fullscale, cfg.score_scale,
            )
            for i in range(b)
        ])
        entry_ok = prop.entry_mask & (entry_cell >= 0)
        s3 = s * s * s
        # live-grid compaction into a shared (B * dense_grid_capacity, S^3)
        # space, so the UNets convolve no dead grids
        gcap = b * min(cfg.dense_grid_capacity, p_cap)
        live = prop.proposal_mask.reshape(-1)
        g_of = torch.cumsum(live.to(i32), 0, dtype=i32) - 1
        g_of = torch.where(live & (g_of < gcap), g_of, torch.full_like(g_of, -1)).reshape(b, p_cap)
        counters["dense_grids_dropped"] = (prop.proposal_mask & (g_of < 0)).sum(dim=1).to(i32)
        pclip = prop.entry_proposal.clamp(min=0)
        e_gid = torch.gather(g_of, 1, pclip.long())
        cell_within = entry_cell - pclip * s3
        entry_site = torch.where(
            entry_ok & (e_gid >= 0), e_gid * s3 + cell_within, torch.full_like(e_gid, -1)
        )
        site_flat = entry_site.reshape(-1)
        nsites = gcap * s3
        grid_flat = segment_mean(
            entry_feats.reshape(-1, fea), site_flat.clamp(min=0), nsites, mask=site_flat >= 0
        )
        occ_flat = torch.zeros((nsites + 1,), dtype=torch.bool, device=dev)
        occ_flat[torch.where(site_flat >= 0, site_flat, torch.full_like(site_flat, nsites)).long()] = True
        grid_feats = grid_flat.reshape(gcap, s, s, s, fea)
        occ = occ_flat[:nsites].reshape(gcap, s, s, s)
        counters["proposal_voxels_dropped"] = torch.zeros((b,), dtype=i32, device=dev)

        # representative point (min point index) and its class
        rep_point = torch.stack([
            segment_min(
                torch.where(prop.entry_mask[i], prop.entry_point[i], torch.full_like(prop.entry_point[i], n)),
                pclip[i], p_cap, mask=prop.entry_mask[i],
            )
            for i in range(b)
        ]).clamp(0, n - 1)
        sem_src = batch.sem_labels if batch.sem_labels is not None else sem_preds
        proposal_sem = torch.gather(sem_src.to(i32), 1, rep_point.long()).clamp(1, c - 1)

        counters["dropped_proposals"] = prop.num_dropped
        counters["ccl_node_overflow"] = prop.ccl_overflow
        counters["ccl_cand_truncated"] = prop.ccl_cand_truncated
        out = dataclasses.replace(
            out, proposals=prop, proposal_sem=proposal_sem, entry_site=entry_site,
            counters=counters,
        )

        c0 = cfg.channels[0]
        if do_score:
            sfeat = self.score_unet(grid_feats, occ)                     # (G, S, S, S, C0)
            neg = torch.tensor(float("-inf"), dtype=sfeat.dtype, device=dev)
            pooled_g = torch.where(occ[..., None], sfeat, neg).reshape(-1, s3, c0).amax(dim=1)
            pooled = pooled_g[g_of.clamp(min=0).long()]
            pooled = torch.where((g_of >= 0)[..., None], pooled, torch.zeros((), device=dev))
            pooled = torch.where(prop.proposal_mask[..., None], pooled, torch.zeros((), device=dev))
            score_all = self.score_head(pooled)                          # (B, P, c-1)
            score_logits = torch.gather(score_all, 2, (proposal_sem - 1).long()[..., None])[..., 0]
            out = dataclasses.replace(
                out, score_logits=score_logits, score_preds=torch.sigmoid(score_logits)
            )

        if do_npcs:
            nfeat = self.npcs_unet(grid_feats, occ)                      # (G, S, S, S, C0)
            nf_flat = nfeat.reshape(-1, c0)
            entry_nf = torch.where(
                (site_flat >= 0)[:, None], nf_flat[site_flat.clamp(min=0).long()],
                torch.zeros((), device=dev),
            ).reshape(b, -1, c0)
            entry_npcs = self.npcs_head(entry_nf).reshape(b, -1, c - 1, 3)
            entry_sem_pred = _gather_rows(sem_preds, prop.entry_point, prop.entry_mask)
            sel = (entry_sem_pred - 1).clamp(0, c - 2).long()
            npcs_preds = torch.gather(
                entry_npcs, 2, sel[..., None, None].expand(b, sel.shape[1], 1, 3)
            )[:, :, 0, :]
            out = dataclasses.replace(out, npcs_preds=npcs_preds)
        return out
