"""The plain reference model: GAPartNet's forward, losses and train step.

A frozen, plain copy of the network the benchmark measures (GAPartNet,
Geng et al., CVPR 2023, arXiv:2211.05272; the reference's
`gapartnet/gapartnet.yaml`), in float32, with no kernel and no capacity.
It imports nothing of the measured program.  Module and parameter names
are the program's, so one state dict made by the benchmark loads into
both.

Departures from the program, each with the same result where the
program's capacities and counters are clean:

  * the proposal UNets always run sparse, over the proposal voxels (the
    program's eval path convolves dense S^3 grids with their unoccupied
    sites zeroed, which gives the same numbers at the occupied sites);
  * grids, clustering tables and proposal counts are sized from the data.
"""

import dataclasses
import math
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from portbench.reference import ops

PROPOSAL_CELL = 32


@dataclasses.dataclass(frozen=True)
class RefConfig:
    """The sizes and rules the reference reads from a configuration's
    `model` block (portbench/configs/<name>.json)."""

    backbone_type: str
    in_channels: int
    num_part_classes: int
    channels: Sequence[int]
    block_repeat: int
    ball_query_radius: float
    min_num_points_per_proposal: int
    score_fullscale: float
    score_scale: float
    ignore_sem_label: int
    offset_loss_weight: float
    voxel_size: Sequence[float]
    level_capacity_divisors: Sequence[int]
    proposal_level_divisors: Sequence[int]
    max_instances: int
    symmetry_indices: Sequence[int]

    @classmethod
    def from_model(cls, d: dict) -> "RefConfig":
        return cls(**{f.name: d[f.name] for f in dataclasses.fields(cls)})

    @property
    def num_levels(self) -> int:
        return len(self.level_capacity_divisors)

    @property
    def proposal_levels(self) -> int:
        return len(self.proposal_level_divisors)


def symmetry_orbits() -> np.ndarray:
    """(5, 24, 3, 3): the NPCS symmetry groups (none, z 180, y 180, 12-fold
    z, 12-fold z with mirrors), row-vector matrices, each padded with its
    first element."""
    def rz(t):
        c, s = math.cos(t), math.sin(t)
        return np.array([[c, s, 0.0], [-s, c, 0.0], [0.0, 0.0, 1.0]])

    def rz_improper(t):
        c, s = math.cos(t), math.sin(t)
        return np.array([[s, c, 0.0], [c, -s, 0.0], [0.0, 0.0, -1.0]])

    eye = np.eye(3)
    orbits = [[eye, eye], [eye, rz(math.pi)], [eye, np.diag([-1.0, 1.0, -1.0])],
              [rz(k * math.pi / 6) for k in range(12)],
              [rz(k * math.pi / 6) for k in range(12)] + [rz_improper(k * math.pi / 6)
                                                          for k in range(1, 13)]]
    table = np.zeros((5, 24, 3, 3), np.float32)
    for t, orbit in enumerate(orbits):
        table[t, :len(orbit)] = np.stack(orbit)
        table[t, len(orbit):] = orbit[0]
    return table


# ------------------------------------------------------------------ modules

class BatchNorm(nn.Module):
    """Batch norm over the last axis, eps 1e-4, momentum 0.1; training
    statistics over the rows the mask marks, in two passes; running
    variance unbiased."""

    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def forward(self, x, mask=None):
        if not self.training:
            mean, var = self.running_mean, self.running_var
        else:
            c = x.shape[-1]
            xf = x.reshape(-1, c)
            w = (torch.ones(xf.shape[0], device=x.device) if mask is None
                 else mask.reshape(-1).to(torch.float32))
            cnt = torch.clamp(w.sum().detach(), min=1.0)
            mean = (xf * w[:, None]).sum(0) / cnt
            var = (((xf - mean) ** 2) * w[:, None]).sum(0) / cnt
            var = torch.maximum(var, torch.zeros((), device=x.device))
            with torch.no_grad():
                unbiased = var * cnt / torch.clamp(cnt - 1.0, min=1.0)
                self.running_mean.mul_(0.9).add_(0.1 * mean)
                self.running_var.mul_(0.9).add_(0.1 * unbiased)
        return (x - mean) * (torch.rsqrt(var + 1e-4) * self.weight) + self.bias


class Conv(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(27, cin, cout))


class ResBlock(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        if cin != cout:
            self.shortcut_kernel = nn.Parameter(torch.zeros(cin, cout))
            self.shortcut_bn = BatchNorm(cout)
        else:
            self.shortcut_kernel = None
        self.conv1 = Conv(cin, cout)
        self.bn1 = BatchNorm(cout)
        self.conv2 = Conv(cout, cout)
        self.bn2 = BatchNorm(cout)

    def forward(self, x, lv: ops.Level):
        sc = x if self.shortcut_kernel is None else self.shortcut_bn(x @ self.shortcut_kernel, lv.mask)
        h = torch.relu(self.bn1(ops.subm_conv(x, lv.nbr, self.conv1.kernel), lv.mask))
        h = self.bn2(ops.subm_conv(h, lv.nbr, self.conv2.kernel), lv.mask)
        return torch.relu(h + sc)


class UBlock(nn.Module):
    def __init__(self, channels, repeat, level=0):
        super().__init__()
        self.level, self.repeat = level, repeat
        c0 = channels[0]
        for r in range(repeat):
            self.add_module(f"enc{r}", ResBlock(c0, c0))
        self.has_child = len(channels) > 1
        if self.has_child:
            c1 = channels[1]
            self.down_kernel = nn.Parameter(torch.zeros(8, c0, c1))
            self.down_bn = BatchNorm(c1)
            self.ublock = UBlock(channels[1:], repeat, level + 1)
            self.up_kernel = nn.Parameter(torch.zeros(8, c1, c0))
            self.up_bn = BatchNorm(c0)
            self.add_module("dec0", ResBlock(2 * c0, c0))
            for r in range(1, repeat):
                self.add_module(f"dec{r}", ResBlock(c0, c0))

    def forward(self, x, levels, downs):
        lv = levels[self.level]
        for r in range(self.repeat):
            x = getattr(self, f"enc{r}")(x, lv)
        if not self.has_child:
            return x
        skip = x
        nxt = levels[self.level + 1]
        d = downs[self.level]
        x = ops.down_conv(x, d, self.down_kernel, nxt.keys.shape[1])
        x = torch.relu(self.down_bn(x, nxt.mask))
        x = self.ublock(x, levels, downs)
        x = torch.relu(self.up_bn(ops.up_conv(x, d, self.up_kernel), lv.mask))
        x = torch.cat([x, skip], dim=-1)
        for r in range(self.repeat):
            x = getattr(self, f"dec{r}")(x, lv)
        return x


class SparseUNet(nn.Module):
    def __init__(self, cin, channels, repeat, stem=True):
        super().__init__()
        self.stem_conv = Conv(cin, channels[0]) if stem else None
        self.stem_bn = BatchNorm(channels[0])
        self.ublock = UBlock(tuple(channels), repeat)

    def forward(self, x, levels, downs):
        lv = levels[0]
        if self.stem_conv is not None:
            x = ops.subm_conv(x, lv.nbr, self.stem_conv.kernel)
        return self.ublock(torch.relu(self.stem_bn(x, lv.mask)), levels, downs)


def masked_max(x, mask):
    low = torch.tensor(torch.finfo(x.dtype).min, dtype=x.dtype, device=x.device)
    return torch.where(mask[..., None], x, low).amax(dim=1)


class STN(nn.Module):
    def __init__(self, cin, k):
        super().__init__()
        self.k = k
        widths = (cin, 64, 128, 1024)
        for i in range(3):
            setattr(self, f"conv{i + 1}", nn.Linear(widths[i], widths[i + 1]))
            setattr(self, f"bn{i + 1}", BatchNorm(widths[i + 1]))
        self.fc1, self.bn4 = nn.Linear(1024, 512), BatchNorm(512)
        self.fc2, self.bn5 = nn.Linear(512, 256), BatchNorm(256)
        self.fc3 = nn.Linear(256, k * k)

    def forward(self, x, mask):
        for i in range(3):
            x = torch.relu(getattr(self, f"bn{i + 1}")(getattr(self, f"conv{i + 1}")(x), mask))
        g = masked_max(x, mask)
        g = torch.relu(self.bn4(self.fc1(g)))
        g = self.fc3(torch.relu(self.bn5(self.fc2(g))))
        return (g + torch.eye(self.k, device=x.device).reshape(-1)).reshape(-1, self.k, self.k)


class PointNetEncoder(nn.Module):
    def __init__(self, cin):
        super().__init__()
        self.stn = STN(cin, 3)
        self.conv1, self.bn1 = nn.Linear(cin, 64), BatchNorm(64)
        self.fstn = STN(64, 64)
        self.conv2, self.bn2 = nn.Linear(64, 128), BatchNorm(128)
        self.conv3, self.bn3 = nn.Linear(128, 1024), BatchNorm(1024)

    def forward(self, x, mask):
        b, n, d = x.shape
        xyz = torch.bmm(x[..., :3], self.stn(x, mask))
        x = torch.cat([xyz, x[..., 3:]], dim=-1)
        x = torch.relu(self.bn1(self.conv1(x), mask))
        pf = torch.bmm(x, self.fstn(x, mask))
        x = torch.relu(self.bn2(self.conv2(pf), mask))
        g = masked_max(self.bn3(self.conv3(x), mask), mask)
        return torch.cat([g[:, None].expand(b, n, g.shape[-1]), pf], dim=-1)


class PointNetBackbone(nn.Module):
    def __init__(self, fea, cin):
        super().__init__()
        self.feat = PointNetEncoder(cin)
        widths = (1088, 512, 256, 256)
        for i in range(3):
            setattr(self, f"conv{i + 1}", nn.Linear(widths[i], widths[i + 1]))
            setattr(self, f"bn{i + 1}", BatchNorm(widths[i + 1]))
        self.conv4 = nn.Linear(256, fea)

    def forward(self, pts, mask):
        x = self.feat(pts, mask)
        for i in range(3):
            x = torch.relu(getattr(self, f"bn{i + 1}")(getattr(self, f"conv{i + 1}")(x), mask))
        return torch.where(mask[..., None], self.conv4(x), torch.zeros((), device=x.device))


# ------------------------------------------------------------------- losses

def _mean_over(values, mask):
    cnt = torch.clamp(mask.sum(), min=1).to(values.dtype)
    return torch.where(mask, values, torch.zeros((), device=values.device)).sum() / cnt


def _abs(x):
    return torch.where(x >= 0, x, -x)


def focal_loss(logits, targets, mask, ignore):
    valid = mask & (targets != ignore)
    t = torch.clamp(targets, 0, logits.shape[-1] - 1).long()
    log_pt = torch.gather(F.log_softmax(logits, dim=-1), -1, t[:, None])[:, 0]
    return _mean_over(-log_pt * (1.0 - torch.exp(log_pt)) ** 2, valid)


def dice_loss(logits, targets, mask):
    c = logits.shape[-1]
    p = torch.softmax(logits, dim=-1)
    onehot = F.one_hot(torch.clamp(targets, 0, c - 1).long(), c).to(logits.dtype) + 1e-6
    dice = 2.0 * (p * onehot).sum(-1) / ((p + onehot).sum(-1) + 1e-8)
    return _mean_over(1.0 - dice, mask)


def offset_loss(off, gt, valid):
    dist = _mean_over(_abs(off - gt).sum(-1), valid)
    tiny = torch.tensor(1e-16, device=off.device)
    gdir = gt / (torch.sqrt(torch.maximum((gt ** 2).sum(-1), tiny))[:, None] + 1e-8)
    pdir = off / (torch.sqrt(torch.maximum((off ** 2).sum(-1), tiny))[:, None] + 1e-8)
    return dist, _mean_over(-(gdir * pdir).sum(-1), valid)


def sigmoid_bce(logits, targets, mask):
    loss = (torch.maximum(logits, torch.zeros((), device=logits.device)) - logits * targets
            + torch.log1p(torch.exp(-_abs(logits))))
    return _mean_over(loss, mask)


def gt_scores(ious):
    mid = ious * 2.0 - 0.5
    return torch.where(ious > 0.75, torch.ones_like(ious), torch.where(ious < 0.25, torch.zeros_like(ious), mid))


def npcs_loss(pred, gt, sym, pid, mask, num_props):
    orbits = torch.as_tensor(symmetry_orbits(), device=pred.device)
    mo = orbits.shape[1]
    q = pred - 0.5
    t_all = torch.matmul((gt[:, :, None] * q[:, None, :]).reshape(-1, 9), orbits.reshape(5 * mo, 9).T)
    d2_all = ((q * q).sum(-1) + (gt * gt).sum(-1))[:, None] - 2.0 * t_all
    sel = torch.clamp(sym, 0, 4).long()
    d2 = torch.gather(d2_all.reshape(-1, 5, mo), 1, sel[:, None, None].expand(-1, 1, mo))[:, 0]
    d2 = torch.maximum(d2, torch.zeros((), device=d2.device))
    per = torch.where(d2 <= 0.01, 5.0 * d2,
                      torch.sqrt(torch.maximum(d2, torch.tensor(1e-12, device=d2.device))) - 0.05)
    ok = mask & (pid >= 0)
    group = torch.where(sym < 3, 0, torch.where(sym == 3, 1, 2))
    seg = pid * 3 + group
    ns = num_props * 3
    per_seg = ops.segment_sum(per, seg, ns, ok) / torch.clamp(
        ops.segment_count(seg, ns, ok), min=1)[:, None].to(per.dtype)
    seg_min = torch.amin(per_seg, dim=-1)
    has = ops.segment_count(seg, ns, ok) > 0
    sg = torch.arange(ns, device=seg.device) % 3
    return sum(_mean_over(seg_min, has & (sg == g)) for g in range(3))


# --------------------------------------------------------------- clustering

def proposals_from_labels(lab1, lab2, valid, min_points):
    """Proposals of one cloud from its two sets' component labels, in
    ascending (set, label) order, those below min_points dropped: (entry
    proposal id (2N,) -1 off, number of proposals)."""
    n = lab1.shape[0]
    m = 2 * n
    dump = torch.full_like(lab1, m)
    keys = torch.cat([torch.where(valid, lab1, dump), torch.where(valid, n + lab2, dump)]).long()
    sizes = torch.zeros((m + 1,), dtype=torch.int64, device=keys.device)
    sizes.index_add_(0, keys, torch.ones_like(keys))
    keep = sizes[:m] >= min_points
    compact = torch.cumsum(keep.to(torch.int64), 0) - 1
    kc = keys.clamp(0, m - 1)
    ok = (keys < m) & keep[kc]
    return torch.where(ok, compact[kc], torch.full_like(kc, -1)), int(keep.sum())


def cluster(xyz, offs, sem, valid, cfg: RefConfig):
    """Hash clustering of one cloud on xyz and xyz + offsets."""
    n = xyz.shape[0]
    both = torch.cat([xyz, xyz + offs])
    lab = ops.hash_components(both, torch.cat([sem, sem]).to(torch.int32), torch.cat([valid, valid]),
                              cfg.ball_query_radius, torch.arange(2 * n, device=xyz.device) >= n)
    return proposals_from_labels(lab[:n], lab[n:] - n, valid, cfg.min_num_points_per_proposal)


def cube_coords(xyz, ep, pid, p, rand_a, rand_b, cfg: RefConfig):
    """Integer cube coordinates in [0, fullscale)^3 of each entry: the
    proposal centred at its (float64-summed) mean, scaled to the cube and
    placed by the jitter."""
    fs = cfg.score_fullscale
    exyz = xyz[ep]
    mask = pid >= 0
    pc = pid.clamp(0, p - 1)
    total = ops.segment_sum(exyz.double(), pc, p, mask)
    count = ops.segment_count(pc, p, mask)
    mean = (total / count.clamp(min=1).double()[:, None]).float()
    cen = exyz - mean[pc]
    cmin = ops.segment_min(cen, pc, p, mask)
    cmax = ops.segment_max(cen, pc, p, mask)
    has = (count > 0)[:, None]
    z = torch.zeros((), device=xyz.device)
    cmin, cmax = torch.where(has, cmin, z), torch.where(has, cmax, z)
    ext = (cmax - cmin).amax(dim=-1)
    scales = torch.clamp(1.0 / torch.clamp(ops.div_const(ext, fs), min=1e-12) - 0.01, max=cfg.score_scale)
    mn, mx = cmin * scales[:, None], cmax * scales[:, None]
    rng = mx - mn
    offs = (-mn + torch.clamp(fs - rng - 0.001, min=0.0) * rand_a[None]
            + torch.clamp(fs - rng + 0.001, max=0.0) * rand_b[None])
    scaled = cen * scales[pc][:, None] + offs[pc]
    return torch.clamp(torch.floor(scaled).to(torch.int32), 0, int(fs) - 1)


def proposal_grids(cfg: RefConfig, xyz, entry_point, entry_pid, p, rand_a, rand_b):
    """The sparse proposal grid of every cloud: each proposal's cube in its
    own PROPOSAL_CELL^3 cell of a super-grid.  Returns (levels, downs, each
    entry's voxel (-1 off), voxels per cloud capacity)."""
    c = PROPOSAL_CELL
    keys_all, vid_all = [], []
    for i in range(xyz.shape[0]):
        ep, pid = entry_point[i].long(), entry_pid[i]
        coords = cube_coords(xyz[i], ep, pid, p, rand_a, rand_b, cfg)
        pc = pid.clamp(min=0)
        cell = torch.stack([pc % c, (pc // c) % c, pc // (c * c)], dim=-1).to(torch.int32)
        keys, vid, _ = ops.dedup_keys(ops.pack_coords(cell * c + coords), pid >= 0)
        keys_all.append(keys)
        vid_all.append(vid)
    keys = torch.stack(keys_all)
    v = max(int((keys != ops.KEY_SENTINEL).sum(1).max()), 1)
    levels, downs = ops.hierarchy(keys[:, :v].contiguous(), cfg.proposal_levels)
    return levels, downs, torch.stack(vid_all), v


def gather_rows(x, idx, ok):
    bidx = torch.arange(x.shape[0], device=x.device)[:, None]
    g = x[bidx, idx.clamp(min=0).long()]
    ok = ok.reshape(ok.shape + (1,) * (g.ndim - ok.ndim))
    return torch.where(ok, g, torch.zeros((), dtype=g.dtype, device=g.device))


# -------------------------------------------------------------------- model

class GAPartNet(nn.Module):
    def __init__(self, cfg: RefConfig):
        super().__init__()
        self.cfg = cfg
        c, fea = cfg.num_part_classes, cfg.channels[0]
        if cfg.backbone_type == "PointNet":
            self.backbone = PointNetBackbone(fea, cfg.in_channels)
        else:
            self.backbone = SparseUNet(cfg.in_channels, cfg.channels, cfg.block_repeat)
        self.sem_seg_head = nn.Linear(fea, c)
        self.offset_mlp0 = nn.Linear(fea, fea)
        self.offset_bn = BatchNorm(fea)
        self.offset_mlp1 = nn.Linear(fea, 3)
        self.score_unet = SparseUNet(fea, cfg.channels[:2], cfg.block_repeat, stem=False)
        self.score_head = nn.Linear(fea, c - 1)
        self.npcs_unet = SparseUNet(fea, cfg.channels[:2], cfg.block_repeat, stem=False)
        self.npcs_head = nn.Linear(fea, 3 * (c - 1))

    def backbone_features(self, points, mask):
        cfg = self.cfg
        if cfg.backbone_type == "PointNet":
            return self.backbone(points, mask)
        keys, feats, pvid = ops.voxelize_batch(points, mask, cfg.voxel_size)
        levels, downs = ops.hierarchy(keys, cfg.num_levels)
        return gather_rows(self.backbone(feats, levels, downs), pvid, pvid >= 0)

    def forward(self, points, mask, labels: Optional[Dict[str, torch.Tensor]] = None,
                cluster_sem=None, cluster_off=None, jitter=None, proposals=None):
        """points (B, N, 6), mask (B, N).  `labels`: sem_labels,
        instance_labels, gt_npcs, instance_regions, num_points_per_instance
        (training).  Proposals from the clustering of (cluster_sem,
        cluster_off), or given as (entry_point (B, E), entry_pid (B, E),
        num_proposals per cloud).  Returns a dict of outputs and losses."""
        cfg = self.cfg
        c = cfg.num_part_classes
        b, n = mask.shape
        dev = points.device
        xyz = points[..., :3]
        out = {}
        feats = self.backbone_features(points, mask)
        sem_logits = self.sem_seg_head(feats)
        sem_preds = torch.argmax(sem_logits.detach(), dim=-1)
        x = torch.relu(self.offset_bn(self.offset_mlp0(feats), mask))
        offset = self.offset_mlp1(x)
        out.update(sem_logits=sem_logits, sem_preds=sem_preds, offset_preds=offset)
        zero = torch.zeros((), device=dev)
        losses = dict(loss_sem_seg=zero, loss_offset_dist=zero, loss_offset_dir=zero,
                      loss_prop_score=zero, loss_prop_npcs=zero)
        if labels is not None:
            sl, il = labels["sem_labels"], labels["instance_labels"]
            fl, fm = sl.reshape(-1), mask.reshape(-1)
            flog = sem_logits.reshape(-1, c)
            losses["loss_sem_seg"] = (focal_loss(flog, fl, fm, cfg.ignore_sem_label)
                                      + dice_loss(flog, fl, fm))
            gt_off = labels["instance_regions"][..., :3] - xyz
            vi = (sl > 0) & (il >= 0) & mask
            d, r = offset_loss(offset.reshape(-1, 3), gt_off.reshape(-1, 3), vi.reshape(-1))
            losses["loss_offset_dist"] = d * cfg.offset_loss_weight
            losses["loss_offset_dir"] = r * cfg.offset_loss_weight

        if proposals is None:
            valid = (cluster_sem > 0) & mask
            if labels is not None:
                valid = valid & (labels["instance_labels"] >= 0)
            per = [cluster(xyz[i], cluster_off[i], cluster_sem[i], valid[i], cfg) for i in range(b)]
            entry_pid = torch.stack([p for p, _ in per])
            nprop = [k for _, k in per]
            entry_point = torch.arange(n, device=dev).repeat(2)[None].expand(b, 2 * n)
        else:
            entry_point, entry_pid, nprop = proposals
        p = max(max(nprop), 1)
        em = entry_pid >= 0
        prop_mask = torch.arange(p, device=dev)[None] < torch.tensor(nprop, device=dev)[:, None]
        out.update(entry_point=entry_point, entry_pid=entry_pid, num_proposals=nprop)

        if self.training:
            rand_a, rand_b = jitter[0].to(dev), jitter[1].to(dev)
        else:
            rand_a = rand_b = torch.full((3,), 0.5, device=dev)
        levels, downs, vid, v = proposal_grids(cfg, xyz, entry_point, entry_pid, p, rand_a, rand_b)
        vok = em & (vid >= 0)
        efeat = gather_rows(feats, entry_point, em)
        vfeats = torch.stack([ops.segment_mean(efeat[i], vid[i], v, vok[i]) for i in range(b)])
        pc = entry_pid.clamp(min=0)

        rep = torch.stack([ops.segment_min(torch.where(em[i], entry_point[i], torch.full_like(entry_point[i], n)),
                                           pc[i], p, em[i]) for i in range(b)]).clamp(0, n - 1)
        sem_src = labels["sem_labels"] if labels is not None else sem_preds
        proposal_sem = torch.gather(sem_src.long(), 1, rep.long()).clamp(1, c - 1)
        out.update(proposal_sem=proposal_sem, proposal_rep=rep)

        sfeat = self.score_unet(vfeats, levels, downs)
        esf = gather_rows(sfeat, vid, vok)
        pooled = torch.stack([ops.segment_max(esf[i], pc[i], p, em[i]) for i in range(b)])
        pooled = torch.where(prop_mask[..., None], pooled, zero)
        score_logits = torch.gather(self.score_head(pooled), 2, (proposal_sem - 1)[..., None])[..., 0]
        out.update(score_logits=score_logits, score_preds=torch.sigmoid(score_logits.detach()))

        nfeat = self.npcs_unet(vfeats, levels, downs)
        enp = gather_rows(self.npcs_head(nfeat), vid, vok).reshape(b, -1, c - 1, 3)
        esem = gather_rows(sem_preds, entry_point, em)
        sel = (esem - 1).clamp(0, c - 2)
        npcs = torch.gather(enp, 2, sel[..., None, None].expand(b, sel.shape[1], 1, 3))[:, :, 0]
        out["npcs_preds"] = npcs

        if labels is not None:
            einst = gather_rows(labels["instance_labels"], entry_point, em)
            nppi = labels["num_points_per_instance"][:, :cfg.max_instances]
            ni = nppi.shape[1]
            ok = em & (einst >= 0) & (einst < ni)
            psize = torch.stack([ops.segment_count(pc[i], p, em[i]) for i in range(b)])
            inter = torch.stack([ops.segment_count(entry_pid[i] * ni + einst[i], p * ni, ok[i])
                                 for i in range(b)]).reshape(b, p, ni).float()
            union = psize.float()[..., None] + nppi.float()[:, None, :] - inter
            ious = inter / torch.clamp(union, min=1.0)
            losses["loss_prop_score"] = sigmoid_bce(score_logits.reshape(-1),
                                                    gt_scores(ious.amax(dim=-1)).reshape(-1),
                                                    prop_mask.reshape(-1))
            esl = gather_rows(labels["sem_labels"], entry_point, em)
            egt = gather_rows(labels["gt_npcs"], entry_point, em)
            nvalid = em & (esem == esl) & (egt != 0).any(dim=-1)
            sym = torch.tensor(cfg.symmetry_indices, device=dev)[esem.clamp(0, c - 1)]
            gpid = torch.where(entry_pid >= 0, entry_pid + torch.arange(b, device=dev)[:, None] * p,
                               torch.full_like(entry_pid, -1))
            losses["loss_prop_npcs"] = npcs_loss(npcs.reshape(-1, 3), egt.reshape(-1, 3),
                                                 sym.reshape(-1), gpid.reshape(-1),
                                                 nvalid.reshape(-1), b * p)
            out["ious"] = ious
        out.update(losses)
        out["total_loss"] = sum(losses.values())
        return out


class Adam:
    """Adam (b1 0.9, b2 0.999, eps 1e-8) over named parameters; a parameter
    the loss did not reach steps with a zero gradient."""

    def __init__(self, named, lr: float):
        self.params = dict(named)
        self.lr = lr
        self.m = {k: torch.zeros_like(p) for k, p in self.params.items()}
        self.v = {k: torch.zeros_like(p) for k, p in self.params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self):
        self.t += 1
        bc1, bc2 = 1 - 0.9 ** self.t, 1 - 0.999 ** self.t
        for k, p in self.params.items():
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            self.m[k].mul_(0.9).add_(g, alpha=0.1)
            self.v[k].mul_(0.999).addcmul_(g, g, value=0.001)
            denom = (self.v[k].sqrt() / math.sqrt(bc2)).add_(1e-8)
            p.addcdiv_(self.m[k], denom, value=-self.lr / bc1)
            p.grad = None


def train_step(model: GAPartNet, opt: Adam, batch, cluster_sem, cluster_off, jitter):
    """One step with all three stages on: forward in train mode, backward
    of the sum of the five losses, Adam.  Returns the outputs."""
    model.train()
    out = model(batch["points"], batch["point_mask"], labels=batch, cluster_sem=cluster_sem,
                cluster_off=cluster_off, jitter=jitter)
    out["total_loss"].backward()
    opt.step()
    return out
