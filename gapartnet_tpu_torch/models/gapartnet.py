"""GAPartNet: backbone + semantic / offset / score / NPCS heads and losses.

Counterpart of the `GAPartNet` module of models/gapartnet.py.  The module's
train / eval mode is the JAX package's `train` flag: training normalizes
with batch statistics (and updates the running ones), places the proposal
cubes with random jitter and runs the proposal UNets sparse, through the
submanifold kernels; eval uses the running statistics, the cube centre and
the dense proposal UNets (`proposal_conv_impl` "auto"; "dense" and
"sparse" pin one path).  Three stage flags select the work as in the JAX
package: `do_cluster`, `do_score`, `do_npcs`.  With labels in the batch the
forward also returns the five losses, the IoUs against ground truth and
the two accuracies; outputs a run does not produce are None.

`frozen_bn` names the modules whose BatchNorms normalize with their running
statistics in a training forward, as the JAX model's `frozen_bn` does: it
reaches the backbone and `offset_bn` only, so the proposal UNets of a frozen
score/NPCS branch keep using batch statistics.

Module and parameter names follow the flax tree (weights.params_from_jax
maps one onto the other).
"""

import contextlib
import dataclasses
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from gapartnet_tpu_torch.config import GAPartNetConfig
from gapartnet_tpu_torch.models import losses as L
from gapartnet_tpu_torch.models.backbone import SparseUNet
from gapartnet_tpu_torch.models.dense_unet import ProposalUNet
from gapartnet_tpu_torch.models.grouping import (
    PROPOSAL_CELL,
    SampleProposals,
    cluster_single,
    segmented_dense_voxelize_single,
    segmented_voxelize_single,
    stack_proposals,
)
from gapartnet_tpu_torch.models.norm import MaskedBatchNorm
from gapartnet_tpu_torch.ops.iou import instance_seg_iou
from gapartnet_tpu_torch.ops.segment import segment_max, segment_mean, segment_min
from gapartnet_tpu_torch.ops.sparse_conv import GridHierarchy, build_hierarchy
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
    ious: Optional[torch.Tensor] = None           # (B, P, I) vs GT instances
    npcs_preds: Optional[torch.Tensor] = None     # (B, 2N, 3)
    npcs_valid: Optional[torch.Tensor] = None     # (B, 2N) entries in the NPCS loss
    # dense proposal-grid site of each entry (B, 2N), -1 = dropped
    entry_site: Optional[torch.Tensor] = None
    # sparse proposal grid: its hierarchy, and each entry's voxel (B, 2N)
    proposal_grid: Optional[GridHierarchy] = None
    entry_voxel_id: Optional[torch.Tensor] = None
    # capacity-overflow counters, (B,) int32 each; all zero in healthy runs
    counters: Optional[Dict[str, torch.Tensor]] = None
    # losses (scalars; zero where a stage is off) and accuracies, with labels
    loss_sem_seg: Optional[torch.Tensor] = None
    loss_offset_dist: Optional[torch.Tensor] = None
    loss_offset_dir: Optional[torch.Tensor] = None
    loss_prop_score: Optional[torch.Tensor] = None
    loss_prop_npcs: Optional[torch.Tensor] = None
    all_accu: Optional[torch.Tensor] = None
    pixel_accu: Optional[torch.Tensor] = None

    LOSSES = ("loss_sem_seg", "loss_offset_dist", "loss_offset_dir",
              "loss_prop_score", "loss_prop_npcs")

    @property
    def total_loss(self) -> torch.Tensor:
        """Sum of the five losses (computed only when the batch has labels)."""
        return sum(getattr(self, k) for k in self.LOSSES)


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


@contextlib.contextmanager
def _running_stats(module: nn.Module, frozen: bool):
    """Within the block, `module`'s BatchNorms use (and keep) their running
    statistics when `frozen` (eval mode; the mode is restored after)."""
    if not (frozen and module.training):
        yield
        return
    module.eval()
    try:
        yield
    finally:
        module.train()


def _gather_rows(x: torch.Tensor, idx: torch.Tensor, ok: torch.Tensor) -> torch.Tensor:
    """x (B, R, ...) gathered at idx (B, Q) -> (B, Q, ...), zeros where ~ok
    (the JAX package's _gather_per_point, _gather_entries and
    _gather_entries_from_voxels)."""
    bidx = torch.arange(x.shape[0], device=x.device)[:, None]
    g = x[bidx, idx.clamp(min=0).long()]
    ok = ok.reshape(ok.shape + (1,) * (g.ndim - ok.ndim))
    return torch.where(ok, g, torch.zeros((), dtype=g.dtype, device=g.device))


class GAPartNet(nn.Module):
    """The full network.  Labels in the batch are optional."""

    def __init__(self, cfg: GAPartNetConfig):
        super().__init__()
        if cfg.backbone_type != "SparseUNet":
            raise NotImplementedError(f"backbone {cfg.backbone_type} is not ported")
        if cfg.clustering_impl != "hash":
            raise NotImplementedError(f"clustering {cfg.clustering_impl} is not ported")
        if cfg.proposal_conv_impl not in ("auto", "dense", "sparse"):
            raise ValueError(f"unknown proposal_conv_impl {cfg.proposal_conv_impl}")
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
        self.score_unet = ProposalUNet(cfg.channels[:2], cfg.block_repeat)
        self.score_head = nn.Linear(fea, c - 1)
        self.npcs_unet = ProposalUNet(cfg.channels[:2], cfg.block_repeat)
        self.npcs_head = nn.Linear(fea, 3 * (c - 1))

    def with_config(self, cfg: GAPartNetConfig) -> "GAPartNet":
        """A GAPartNet that runs with `cfg` (other capacities, e.g. the eval
        ones of config.eval_capacity_config) on this model's own submodules,
        so on its parameters and buffers, not on a copy."""
        for f in ("in_channels", "num_part_classes", "backbone_type", "channels", "block_repeat"):
            if getattr(cfg, f) != getattr(self.cfg, f):
                raise ValueError(f"with_config: {f} {getattr(cfg, f)} differs from the model's "
                                 f"{getattr(self.cfg, f)}")
        view = GAPartNet.__new__(GAPartNet)
        nn.Module.__init__(view)
        view.cfg = cfg
        for name, child in self.named_children():
            view.add_module(name, child)
        return view.train(self.training)

    def forward(
        self,
        batch: PointCloudBatch,
        do_cluster: bool = False,
        do_score: bool = False,
        do_npcs: bool = False,
        cluster_sem_override: Optional[torch.Tensor] = None,
        cluster_offset_override: Optional[torch.Tensor] = None,
        jitter: Optional[torch.Tensor] = None,
        proposals_override: Optional[SampleProposals] = None,
        frozen_bn: Tuple[str, ...] = (),
    ) -> ModelOutput:
        """proposals_override: externally supplied point groups (batched
        SampleProposals, e.g. instance masks) that replace clustering;
        everything downstream is unchanged.

        cluster_sem_override / cluster_offset_override drive clustering
        with supplied labels and offsets instead of the heads' outputs (the
        bench's trained-operating-point load); the heads still run.

        jitter: (2, 3) uniform [0, 1) draws (rand_a, rand_b) placing the
        proposal cubes in training (train.loop.train_step draws them); eval
        places every cube at the centre.

        frozen_bn: see the module docstring (train.loop.train_step passes its
        freeze_prefixes)."""
        cfg = self.cfg
        train = self.training
        c = cfg.num_part_classes
        points, point_mask = batch.points, batch.point_mask
        b, n = point_mask.shape
        dev = points.device
        i32 = torch.int32
        pt_xyz = points[..., :3]
        fea = cfg.channels[0]
        zero = torch.zeros((), device=dev)
        counters = {}
        has_labels = batch.sem_labels is not None
        losses = {k: zero for k in ModelOutput.LOSSES} if has_labels else {}

        # input grid + backbone
        keys, vfeats, nvox, pc_voxel_id = prepare_input_grid(points, point_mask, cfg)
        hierarchy = build_hierarchy(
            keys, nvox, cfg.input_capacities(), extent=cfg.input_grid_extent
        )
        counters["backbone_voxels_dropped"] = sum(ds.num_dropped for ds in hierarchy.downsamples)
        with _running_stats(self.backbone, "backbone" in frozen_bn):
            voxel_out = self.backbone(vfeats.contiguous(), hierarchy)
        pc_feats = _gather_rows(voxel_out, pc_voxel_id, pc_voxel_id >= 0)   # (B, N, fea)

        # semantic head
        sem_logits = self.sem_seg_head(pc_feats)
        sem_preds = torch.argmax(sem_logits.detach(), dim=-1).to(i32)
        all_accu = pixel_accu = None
        if has_labels:
            flat_logits = sem_logits.reshape(-1, c)
            flat_labels = batch.sem_labels.reshape(-1)
            flat_mask = point_mask.reshape(-1)
            sem_loss = L.focal_loss if cfg.use_sem_focal_loss else L.cross_entropy_loss
            kw = dict(gamma=2.0) if cfg.use_sem_focal_loss else {}
            loss_sem = sem_loss(flat_logits, flat_labels, flat_mask,
                                ignore_index=cfg.ignore_sem_label, alpha=cfg.sem_focal_alpha, **kw)
            if cfg.use_sem_dice_loss:
                loss_sem = loss_sem + L.dice_loss(flat_logits, flat_labels, flat_mask)
            losses["loss_sem_seg"] = loss_sem
            flat_preds = sem_preds.reshape(-1)
            all_accu = L.pixel_accuracy(flat_preds, flat_labels, flat_mask)
            pixel_accu = L.pixel_accuracy(flat_preds, flat_labels, flat_mask & (flat_labels > 0))

        # offset head
        with _running_stats(self.offset_bn, "offset_bn" in frozen_bn):
            x = torch.relu(self.offset_bn(self.offset_mlp0(pc_feats), point_mask))
        offset_preds = self.offset_mlp1(x)
        if has_labels and batch.instance_regions is not None:
            gt_offsets = batch.instance_regions[..., :3] - pt_xyz
            valid_inst = (batch.sem_labels > 0) & (batch.instance_labels >= 0) & point_mask
            dist, direction = L.offset_loss(
                offset_preds.reshape(-1, 3), gt_offsets.reshape(-1, 3), valid_inst.reshape(-1)
            )
            losses["loss_offset_dist"] = dist * cfg.offset_loss_weight
            losses["loss_offset_dir"] = direction * cfg.offset_loss_weight

        out = ModelOutput(
            sem_logits=sem_logits, sem_preds=sem_preds, offset_preds=offset_preds,
            pc_features=pc_feats, counters=counters, all_accu=all_accu,
            pixel_accu=pixel_accu, **losses,
        )
        if not do_cluster:
            return out

        # dual-set clustering
        cluster_sem = sem_preds if cluster_sem_override is None else cluster_sem_override
        cluster_valid = (cluster_sem > 0) & point_mask
        if has_labels and batch.instance_labels is not None:
            cluster_valid = cluster_valid & (batch.instance_labels >= 0)
        offs = offset_preds.detach() if cluster_offset_override is None else cluster_offset_override
        node_cap = min(cfg.hash_node_capacity, cfg.max_points) if cfg.hash_node_capacity else 0
        if proposals_override is not None:
            prop = proposals_override
        else:
            prop = stack_proposals([
                cluster_single(
                    pt_xyz[i], offs[i], cluster_sem[i], cluster_valid[i],
                    cfg.ball_query_radius, cfg.min_num_points_per_proposal, cfg.max_proposals,
                    hash_node_capacity=node_cap, hash_cand_cap=cfg.hash_cand_cap,
                    hash_max_degree=cfg.hash_max_degree,
                )
                for i in range(b)
            ])
        samples = [SampleProposals(*[f[i] for f in prop]) for i in range(b)]

        # cube placement: random jitter in training, the cube centre in eval
        if train:
            if jitter is None:
                raise ValueError("a training forward with clustering needs `jitter`, "
                                 "(2, 3) uniform draws")
            jitter = jitter.to(device=dev, dtype=torch.float32)
            rand_a, rand_b = jitter[0], jitter[1]
        else:
            rand_a = rand_b = torch.full((3,), 0.5, dtype=torch.float32, device=dev)
        dense_mode = cfg.proposal_conv_impl == "dense" or (
            cfg.proposal_conv_impl == "auto" and not train
        )
        entry_feats = _gather_rows(pc_feats, prop.entry_point, prop.entry_mask)
        s = int(cfg.score_fullscale)
        p_cap = cfg.max_proposals
        if dense_mode:
            entry_cell = torch.stack([
                segmented_dense_voxelize_single(
                    pt_xyz[i], samples[i], rand_a, rand_b, p_cap,
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
            out = dataclasses.replace(out, entry_site=entry_site)
        else:
            grids = [
                segmented_voxelize_single(
                    pt_xyz[i], samples[i], rand_a, rand_b, p_cap,
                    cfg.score_fullscale, cfg.score_scale,
                )
                for i in range(b)
            ]
            # cap the proposal-grid voxels: keys are sorted, so slicing keeps
            # the lowest keys; entries of dropped voxels detach
            vcap = cfg.proposal_capacities()[0]
            grid_keys = torch.stack([g.keys[:vcap] for g in grids])
            grid_nv = torch.stack([g.num_voxels for g in grids])
            grid_nvox = torch.clamp(grid_nv, max=vcap)
            entry_voxel_id = torch.stack([g.entry_voxel_id for g in grids])
            entry_voxel_id = torch.where(
                entry_voxel_id < vcap, entry_voxel_id, torch.full_like(entry_voxel_id, -1)
            )
            # extent: one PROPOSAL_CELL^3 cell per proposal on the super-grid
            cell = PROPOSAL_CELL
            pext = (
                1024,
                cell * min(-(-p_cap // cell), cell),
                cell * (-(-p_cap // (cell * cell))),
            )
            prop_hier = build_hierarchy(grid_keys, grid_nvox, cfg.proposal_capacities(), extent=pext)
            entry_voxel_ok = prop.entry_mask & (entry_voxel_id >= 0)
            prop_vfeats = torch.stack([
                segment_mean(entry_feats[i], entry_voxel_id[i].clamp(min=0), vcap,
                             mask=entry_voxel_ok[i])
                for i in range(b)
            ])
            counters["proposal_voxels_dropped"] = (grid_nv - grid_nvox) + sum(
                ds.num_dropped for ds in prop_hier.downsamples
            )
            out = dataclasses.replace(out, proposal_grid=prop_hier, entry_voxel_id=entry_voxel_id)

        # representative point (min point index) and its class
        pclip = prop.entry_proposal.clamp(min=0)
        rep_point = torch.stack([
            segment_min(
                torch.where(prop.entry_mask[i], prop.entry_point[i], torch.full_like(prop.entry_point[i], n)),
                pclip[i], p_cap, mask=prop.entry_mask[i],
            )
            for i in range(b)
        ]).clamp(0, n - 1)
        sem_src = batch.sem_labels if has_labels else sem_preds
        proposal_sem = torch.gather(sem_src.to(i32), 1, rep_point.long()).clamp(1, c - 1)

        # IoU against the ground-truth instances, for the score loss
        ious = None
        if has_labels and batch.instance_labels is not None:
            entry_inst = _gather_rows(batch.instance_labels, prop.entry_point, prop.entry_mask)
            entry_inst = torch.where(prop.entry_mask, entry_inst, torch.full_like(entry_inst, -100))
            ious = torch.stack([
                instance_seg_iou(
                    prop.entry_proposal[i], entry_inst[i], prop.entry_mask[i],
                    prop.proposal_size[i], batch.num_points_per_instance[i, : cfg.max_instances],
                    num_proposals=p_cap, num_instances=cfg.max_instances,
                )
                for i in range(b)
            ])

        counters["dropped_proposals"] = prop.num_dropped
        counters["ccl_node_overflow"] = prop.ccl_overflow
        counters["ccl_cand_truncated"] = prop.ccl_cand_truncated
        out = dataclasses.replace(
            out, proposals=prop, proposal_sem=proposal_sem, ious=ious, counters=counters,
        )

        c0 = cfg.channels[0]
        entry_vox_ok = None if dense_mode else prop.entry_mask & (entry_voxel_id >= 0)
        if do_score:
            if dense_mode:
                sfeat = self.score_unet.dense(grid_feats, occ)           # (G, S, S, S, C0)
                neg = torch.tensor(float("-inf"), dtype=sfeat.dtype, device=dev)
                pooled_g = torch.where(occ[..., None], sfeat, neg).reshape(-1, s3, c0).amax(dim=1)
                pooled = _gather_rows(pooled_g[None], g_of.reshape(1, -1), (g_of >= 0).reshape(1, -1))
                pooled = pooled.reshape(b, p_cap, c0)
            else:
                sfeat = self.score_unet(prop_vfeats, prop_hier)          # (B, Vp, C0)
                entry_sf = _gather_rows(sfeat, entry_voxel_id, entry_vox_ok)
                # entries of one voxel tie; segment_max splits the gradient
                pooled = torch.stack([
                    segment_max(entry_sf[i], pclip[i], p_cap, mask=prop.entry_mask[i])
                    for i in range(b)
                ])
            pooled = torch.where(prop.proposal_mask[..., None], pooled, zero)
            score_all = self.score_head(pooled)                          # (B, P, c-1)
            score_logits = torch.gather(score_all, 2, (proposal_sem - 1).long()[..., None])[..., 0]
            if ious is not None:
                gt_scores = L.get_gt_scores(ious.amax(dim=-1), 0.75, 0.25)
                losses["loss_prop_score"] = L.sigmoid_bce(
                    score_logits.reshape(-1), gt_scores.reshape(-1), prop.proposal_mask.reshape(-1)
                )
            out = dataclasses.replace(
                out, score_logits=score_logits, score_preds=torch.sigmoid(score_logits.detach()),
                **losses,
            )

        if do_npcs:
            if dense_mode:
                nfeat = self.npcs_unet.dense(grid_feats, occ)            # (G, S, S, S, C0)
                entry_nf = _gather_rows(
                    nfeat.reshape(1, -1, c0), entry_site.reshape(1, -1), entry_site.reshape(1, -1) >= 0
                ).reshape(b, -1, c0)
                entry_npcs = self.npcs_head(entry_nf)
            else:
                nfeat = self.npcs_unet(prop_vfeats, prop_hier)           # (B, Vp, C0)
                entry_npcs = _gather_rows(self.npcs_head(nfeat), entry_voxel_id, entry_vox_ok)
            entry_npcs = entry_npcs.reshape(b, -1, c - 1, 3)
            entry_sem_pred = _gather_rows(sem_preds, prop.entry_point, prop.entry_mask)
            sel = (entry_sem_pred - 1).clamp(0, c - 2).long()
            npcs_preds = torch.gather(
                entry_npcs, 2, sel[..., None, None].expand(b, sel.shape[1], 1, 3)
            )[:, :, 0, :]
            npcs_valid = None
            if has_labels and batch.gt_npcs is not None:
                entry_sem_label = _gather_rows(batch.sem_labels, prop.entry_point, prop.entry_mask)
                entry_gt_npcs = _gather_rows(batch.gt_npcs, prop.entry_point, prop.entry_mask)
                npcs_valid = (
                    prop.entry_mask & (entry_sem_pred == entry_sem_label)
                    & (entry_gt_npcs != 0).any(dim=-1)
                )
                sym_idx = torch.tensor(cfg.symmetry_indices, dtype=i32, device=dev)
                entry_sym = sym_idx[entry_sem_pred.clamp(0, c - 1).long()]
                # one segment space over the batch
                gpid = torch.where(
                    prop.entry_proposal >= 0,
                    prop.entry_proposal + torch.arange(b, dtype=i32, device=dev)[:, None] * p_cap,
                    torch.full_like(prop.entry_proposal, -1),
                )
                losses["loss_prop_npcs"] = L.npcs_loss(
                    npcs_preds.reshape(-1, 3), entry_gt_npcs.reshape(-1, 3),
                    entry_sym.reshape(-1), gpid.reshape(-1), npcs_valid.reshape(-1), b * p_cap,
                )
            out = dataclasses.replace(out, npcs_preds=npcs_preds, npcs_valid=npcs_valid, **losses)
        return out
