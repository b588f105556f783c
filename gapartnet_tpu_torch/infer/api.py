"""Single-object inference API (counterpart of infer/api.py).

RGB-D back-projection, FPS downsampling and ball-space normalisation, the
full perception forward, the score / size filter with NMS, the instance and
NPCS maps over the input cloud, and one RANSAC / Umeyama 9-DoF part box per
kept proposal (reference structure/utils.py:118-192, structure/gapartnet.py
:466-705).

`GAPartNetInference.predict` runs in four stages: the forward and the
selection (NMS) on the device; one copy of the outputs to the host, where
the instance and NPCS maps are scattered and the box-fitting jobs are laid
out; the RANSAC fits of all jobs at once on the device, with minimal samples
drawn on the CPU (`ops.umeyama.ransac_samples`).
"""

import dataclasses
import os
from typing import List, Mapping, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from gapartnet_tpu_torch.config import GAPartNetConfig
from gapartnet_tpu_torch.data.capacity import _counts_and_span
from gapartnet_tpu_torch.entry import use_fp32_math
from gapartnet_tpu_torch.eval.ap import _proposal_pred_classes, select_eval_proposals
from gapartnet_tpu_torch.models.gapartnet import GAPartNet, ModelOutput
from gapartnet_tpu_torch.models.grouping import SampleProposals
from gapartnet_tpu_torch.ops.cpd import rigid_cpd
from gapartnet_tpu_torch.ops.fps import furthest_point_sampling_single
from gapartnet_tpu_torch.ops.umeyama import (
    PoseFit,
    ransac_pose_from_npcs,
    ransac_samples,
    umeyama_masked,
)
from gapartnet_tpu_torch.structures import PointCloudBatch
from gapartnet_tpu_torch.weights import init_weights

NPCS_BACKGROUND = 230.0 / 255.0  # reference fill (structure/utils.py:155)


def backproject_depth(depth: np.ndarray, K: np.ndarray, rgb: Optional[np.ndarray] = None,
                      flip_yz: bool = False):
    """Depth map -> camera-frame point cloud (the reference's per-pixel
    loop, structure/gapartnet.py:557-586, vectorised).  Zero-depth pixels are
    dropped.  Returns (xyz (M, 3) float32, rgb (M, 3) in [0, 1] with the
    channels reversed, as the reference reads cv2's BGR, or None, pixel
    (M, 2) yx)."""
    h, w = depth.shape
    ys, xs = np.mgrid[0:h, 0:w]
    z = depth.astype(np.float64)
    x = (xs - K[0, 2]) * z / K[0, 0]
    y = (ys - K[1, 2]) * z / K[1, 1]
    xyz = np.stack([x, y, z], axis=-1).reshape(-1, 3)
    valid = (depth != 0).reshape(-1)
    xyz = xyz[valid]
    if flip_yz:  # mode == 2 in the reference
        xyz[:, 1] = -xyz[:, 1]
        xyz[:, 2] = -xyz[:, 2]
    pix = np.stack([ys, xs], axis=-1).reshape(-1, 2)[valid]
    colors = None
    if rgb is not None:
        # the channel reversal is a negative-stride view: copy it
        colors = np.ascontiguousarray((rgb.reshape(-1, rgb.shape[-1])[valid] / 255.0)[:, ::-1])
    return xyz.astype(np.float32), colors, pix


def ball_space_normalize(xyz: np.ndarray):
    """Centre at the mean, scale by the largest radius.  Returns (normalised
    xyz, trans = [max_radius, cx, cy, cz]) as the dataset converter
    (convert_rendered_into_input.py:79-87)."""
    center = xyz.mean(0)
    centered = xyz - center
    max_radius = np.linalg.norm(centered, axis=1).max()
    return (centered / max_radius).astype(np.float32), np.array([max_radius, *center], np.float32)


def fps_downsample(xyz: np.ndarray, num_samples: int = 20000, pre_cap_factor: int = 4,
                   seed: int = 0, device="cuda") -> np.ndarray:
    """A random pre-crop to pre_cap_factor * num_samples (NumPy RandomState),
    then furthest point sampling to num_samples on `device`
    (structure/gapartnet.py:588-615).  Returns indices into `xyz`."""
    n = xyz.shape[0]
    if n <= num_samples:
        return np.arange(n)
    rng = np.random.RandomState(seed)
    if n > pre_cap_factor * num_samples:
        pre = rng.choice(n, pre_cap_factor * num_samples, replace=False)
    else:
        pre = np.arange(n)
    pts = torch.from_numpy(np.ascontiguousarray(xyz[pre], dtype=np.float32)).to(device)
    return pre[furthest_point_sampling_single(pts, num_samples).cpu().numpy()]


@dataclasses.dataclass
class InferenceResult:
    """Per-object outputs (reference Result, structure/instances.py:38-44,
    plus boxes as in tools/visu.py / demo.ipynb)."""

    sem_preds: np.ndarray          # (N,) part class per point
    ins_preds: np.ndarray          # (N,) instance id per point (0 = none)
    npcs_map: np.ndarray           # (N, 3), background = 230/255
    proposal_scores: np.ndarray    # (P,) kept proposals
    proposal_classes: np.ndarray   # (P,)
    bboxes: List[np.ndarray]       # per kept proposal with an ok fit: (8, 3) corners


@dataclasses.dataclass
class FitJobs:
    """The box-fitting jobs of one request, laid out on the host: job j
    fits the NPCS `src[j]` (centred) to the points `tgt[j]` over `mask[j]`."""

    src: np.ndarray    # (J, M, 3) float32
    tgt: np.ndarray    # (J, M, 3) float32
    mask: np.ndarray   # (J, M) bool
    owner: np.ndarray  # (J,) index of the proposal (or mask) each job fits


class Request(NamedTuple):
    """What one request produced, stage by stage."""

    out: ModelOutput
    keep: torch.Tensor          # (P,) bool on the device
    result: InferenceResult
    jobs: Optional[FitJobs]
    fits: Optional[PoseFit]     # on the device
    ok: np.ndarray              # (J,) bool
    boxes: np.ndarray           # (J, 8, 3)


def _last_writes(points: np.ndarray) -> np.ndarray:
    """Positions of the last occurrence of each distinct value of `points`:
    what a loop of assignments in this order leaves behind."""
    _, first_rev = np.unique(points[::-1], return_index=True)
    return len(points) - 1 - first_rev


def _group_entries(group_of_entry: np.ndarray):
    """Entries of groups >= 0, ordered by group and then by entry index
    (the order of the JAX package's per-group loops).  Returns (entries,
    their group, their position within the group, entries per group)."""
    ent = np.nonzero(group_of_entry >= 0)[0]
    ent = ent[np.argsort(group_of_entry[ent], kind="stable")]
    grp = group_of_entry[ent]
    counts = np.bincount(grp) if len(grp) else np.zeros(0, np.int64)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int64)
    return ent, grp, np.arange(len(ent)) - starts[grp], counts


def _fit_jobs(ent, grp, pos, counts, npcs, xyz, ep, n, min_bbox_points) -> Optional[FitJobs]:
    """One job per group with more than `min_bbox_points` entries, padded
    to the largest: src = npcs - 0.5, tgt = the entry's point (clipped to
    the cloud), mask = the entry's point lies in the cloud."""
    fit = np.nonzero(counts > min_bbox_points)[0]
    if len(fit) == 0:
        return None
    job_of = np.full(len(counts), -1, np.int64)
    job_of[fit] = np.arange(len(fit))
    j = job_of[grp]
    f = j >= 0
    cap = int(counts[fit].max())
    src = np.zeros((len(fit), cap, 3), np.float32)
    tgt = np.zeros((len(fit), cap, 3), np.float32)
    mask = np.zeros((len(fit), cap), bool)
    e = ent[f]
    src[j[f], pos[f]] = npcs[e] - 0.5
    tgt[j[f], pos[f]] = xyz[np.clip(ep[e], 0, n - 1)]
    mask[j[f], pos[f]] = ep[e] < n
    return FitJobs(src=src, tgt=tgt, mask=mask, owner=fit)


class GAPartNetInference:
    """Single-object inference with one model: eval mode, all three stages
    on, no gradient (the reference's _load_perception_model +
    _inference_perception_model, structure/utils.py:118-192, 324-343).

    `state_dict`: the model's weights, as a mapping (for example
    `weights.params_from_jax(variables)`) or the path of a `.pt` file
    holding one; without it the weights are drawn from `seed`
    (`weights.init_weights`).  `auto_capacity` sizes the backbone's level
    capacities and grid extent from the first cloud (1024-point and 32-cell
    buckets) and only ever grows them; the weights are capacity-independent
    and stay.  Sets TF32 off (`entry.use_fp32_math`)."""

    def __init__(
        self,
        cfg: Optional[GAPartNetConfig] = None,
        state_dict: Optional[Union[Mapping[str, torch.Tensor], str, os.PathLike]] = None,
        seed: int = 0,
        auto_capacity: bool = False,
        device="cuda",
    ):
        use_fp32_math()
        self.device = torch.device(device)
        self.auto_capacity = auto_capacity
        self._capacity_fitted = False
        self.cfg = cfg or GAPartNetConfig()
        model = GAPartNet(self.cfg)
        if state_dict is None:
            init_weights(model, torch.Generator().manual_seed(seed))
        else:
            if isinstance(state_dict, (str, os.PathLike)):
                state_dict = torch.load(state_dict, map_location="cpu", weights_only=True)
            model.load_state_dict(state_dict, strict=True)
        self.model = model.eval().to(self.device)

    def _ensure_capacity(self, points: np.ndarray) -> None:
        """Grow the level capacities and the grid extent to cover this cloud
        (auto_capacity mode); the model keeps its weights."""
        if not self.auto_capacity:
            return
        levels = len(self.cfg.level_capacity_divisors)
        counts, span = _counts_and_span(points[:, :3].astype(np.float64), self.cfg.voxel_size, levels)
        needed = tuple(min(max(-(-int(c * 1.08) // 1024) * 1024, 128), self.cfg.max_points)
                       for c in counts)
        ext = tuple(max(-(-int(s * 1.08) // 32) * 32, 32) for s in span)
        cur = self.cfg.input_capacities()
        cur_ext = self.cfg.input_grid_extent
        if self._capacity_fitted:
            if all(a <= c for a, c in zip(needed, cur)) and all(e <= c for e, c in zip(ext, cur_ext)):
                return
            needed = tuple(max(a, c) for a, c in zip(needed, cur))
            ext = tuple(max(e, c) for e, c in zip(ext, cur_ext))
        self.cfg = dataclasses.replace(self.cfg, level_capacities=needed, input_grid_extent=ext)
        self.model.cfg = self.cfg
        self._capacity_fitted = True

    def _wrap_points(self, points: np.ndarray) -> PointCloudBatch:
        n, cap = points.shape[0], self.cfg.max_points
        if n > cap:
            raise ValueError(f"{n} points exceed max_points {cap}")
        pts = np.pad(points.astype(np.float32), ((0, cap - n), (0, 0)))
        return PointCloudBatch(
            points=torch.from_numpy(pts)[None].to(self.device),
            point_mask=(torch.arange(cap) < n)[None].to(self.device),
            pc_ids=["inference"],
        )

    def _forward(self, points: np.ndarray, proposals: Optional[SampleProposals] = None):
        """The model's eval forward on one cloud (capacities grown first)."""
        self._ensure_capacity(points)
        batch = self._wrap_points(points)
        with torch.no_grad():
            return self.model(batch, do_cluster=True, do_score=True, do_npcs=True,
                              proposals_override=proposals)

    def _select(self, out) -> torch.Tensor:
        """Score / size filter and NMS on the device: keep mask (P,)."""
        return select_eval_proposals(out, self.cfg, self.cfg.max_points)[0]

    def _scatter(self, points: np.ndarray, out, keep: torch.Tensor, min_bbox_points: int):
        """Copy the outputs to the host once; scatter the instance and NPCS
        maps (a point in two kept proposals takes the later one's, as the
        JAX package's loop leaves it) and lay out the fitting jobs (kept
        proposals with more than min_bbox_points entries, in rank order).
        With keep = the first m slots this is predict_with_masks' scatter.
        Returns (InferenceResult without boxes, FitJobs or None)."""
        n = points.shape[0]
        prop = out.proposals
        cls = _proposal_pred_classes(prop, out.sem_preds)
        keep, ep, pid, em, scores, npcs, sem, cls = (
            t.cpu().numpy() for t in (keep, prop.entry_point[0], prop.entry_proposal[0],
                                      prop.entry_mask[0], out.score_preds[0], out.npcs_preds[0],
                                      out.sem_preds[0], cls[0]))
        kept_ids = np.nonzero(keep)[0]
        rank_of = np.full(len(keep), -1, np.int64)
        rank_of[kept_ids] = np.arange(len(kept_ids))
        e_rank = np.where(em, rank_of[np.clip(pid, 0, len(keep) - 1)], -1)
        ent, grp, pos, counts = _group_entries(e_rank)

        ins_preds = np.zeros(n, np.int64)
        npcs_map = np.full((n, 3), NPCS_BACKGROUND, np.float32)
        in_range = ep[ent] < n
        w_ent = ent[in_range]
        last = _last_writes(ep[w_ent])
        ins_preds[ep[w_ent[last]]] = e_rank[w_ent[last]] + 1
        npcs_map[ep[w_ent[last]]] = npcs[w_ent[last]]
        jobs = _fit_jobs(ent, grp, pos, counts, npcs, points[:, :3], ep, n, min_bbox_points)
        result = InferenceResult(
            sem_preds=sem[:n], ins_preds=ins_preds, npcs_map=npcs_map,
            proposal_scores=scores[kept_ids], proposal_classes=cls[kept_ids], bboxes=[],
        )
        return result, jobs

    def _fit(self, jobs: FitJobs, ransac_iters: int, seed: int) -> PoseFit:
        """RANSAC + Umeyama over every job at once on the device; the
        minimal samples come from a CPU generator seeded with `seed`."""
        samples = ransac_samples(torch.from_numpy(jobs.mask), ransac_iters,
                                 torch.Generator().manual_seed(seed))
        src, tgt, mask, samples = (torch.as_tensor(a).to(self.device)
                                   for a in (jobs.src, jobs.tgt, jobs.mask, samples))
        return ransac_pose_from_npcs(src, tgt, mask, samples)

    def _request(self, points: np.ndarray, proposals: Optional[SampleProposals] = None,
                 ransac_iters: int = 100, min_bbox_points: int = 10, seed: int = 0,
                 mark=None) -> Request:
        """One request in its four stages: the forward; the selection (the
        filter and NMS, or with given proposals all of them); the host
        scatter; the RANSAC fits, with their ok flags and boxes copied to
        the host.  `mark(stage)`, if given, is called after each stage."""
        mark = mark or (lambda stage: None)
        out = self._forward(points, proposals)
        mark("forward")
        keep = self._select(out) if proposals is None else proposals.proposal_mask[0]
        mark("select")
        result, jobs = self._scatter(points, out, keep, min_bbox_points)
        mark("scatter")
        fits, ok, boxes = None, np.zeros(0, bool), np.zeros((0, 8, 3), np.float32)
        if jobs is not None:
            fits = self._fit(jobs, ransac_iters, seed)
            ok, boxes = fits.ok.cpu().numpy(), fits.bbox.cpu().numpy()
        result.bboxes = [boxes[j] for j in np.nonzero(ok)[0]]
        mark("ransac")
        return Request(out, keep, result, jobs, fits, ok, boxes)

    def predict(self, points: np.ndarray, ransac_iters: int = 100, min_bbox_points: int = 10,
                seed: int = 0) -> InferenceResult:
        """points: (N, 6) xyz (ball-normalised) + rgb.  forward -> score /
        size filter + NMS -> instance and NPCS maps -> RANSAC boxes."""
        return self._request(points, None, ransac_iters, min_bbox_points, seed).result

    def _mask_proposals(self, masks: np.ndarray, n: int) -> SampleProposals:
        """Instance masks (M, N) -> batched SampleProposals on the device:
        the first max_proposals masks, their points in ascending order, at
        most 2 * max_points entries."""
        cap = 2 * self.cfg.max_points
        p = self.cfg.max_proposals
        m = min(masks.shape[0], p)
        entry_point = np.zeros(cap, np.int32)
        entry_prop = np.full(cap, -1, np.int32)
        sizes = np.zeros(p, np.int32)
        pos = 0
        for i in range(m):
            idxs = np.nonzero(masks[i][:n])[0]
            k = min(len(idxs), cap - pos)
            entry_point[pos:pos + k] = idxs[:k]
            entry_prop[pos:pos + k] = i
            sizes[i] = k
            pos += k

        def dev(a):
            return torch.from_numpy(np.asarray(a))[None].to(self.device)

        return SampleProposals(
            entry_point=dev(entry_point),
            entry_proposal=dev(entry_prop),
            entry_mask=dev(entry_prop >= 0),
            proposal_size=dev(sizes),
            proposal_mask=dev(np.arange(p) < m),
            num_proposals=dev(np.int32(m)),
            num_dropped=dev(np.int32(max(masks.shape[0] - m, 0))),
            ccl_overflow=dev(np.int32(0)),
            ccl_cand_truncated=dev(np.int32(0)),
        )

    def predict_with_masks(self, points: np.ndarray, masks: np.ndarray, ransac_iters: int = 100,
                           min_bbox_points: int = 10, seed: int = 0):
        """Mask-conditioned pose estimation (the reference's
        _estimate_pose_with_masks, structure/utils.py:195-322): the given
        instance masks replace the network's clustering; ScoreNet and NPCSNet
        run on them, and a 9-DoF box is fitted per mask.  The request runs
        as predict's, every given mask kept.

        points: (N, 6); masks: (M, N) bool.  Returns (scores (M,), classes
        (M,), npcs_map (N, 3), per mask an (8, 3) box or None)."""
        m = min(masks.shape[0], self.cfg.max_proposals)
        req = self._request(points, self._mask_proposals(masks, points.shape[0]), ransac_iters,
                            min_bbox_points, seed)
        bboxes = [None] * m
        if req.jobs is not None:
            for j, i in enumerate(req.jobs.owner):
                bboxes[i] = req.boxes[j] if req.ok[j] else None
        r = req.result
        return r.proposal_scores, r.proposal_classes, r.npcs_map, bboxes

    def predict_depth(self, depth: np.ndarray, K: np.ndarray, rgb: Optional[np.ndarray] = None,
                      **kw) -> Tuple[InferenceResult, np.ndarray, np.ndarray]:
        """RGB-D entry point (ObjIns.get_pc + get_downsampled_pc +
        inference_GAPartNet): back-project, FPS to max_points on the device,
        ball-normalise, predict.  Returns (result, sampled point indices,
        trans)."""
        xyz, colors, _ = backproject_depth(depth, K, rgb)
        idx = fps_downsample(xyz, self.cfg.max_points, device=self.device)
        xyz_n, trans = ball_space_normalize(xyz[idx])
        cols = colors[idx] if colors is not None else np.zeros_like(xyz_n)
        pts = np.concatenate([xyz_n, cols], axis=1)
        return self.predict(pts, **kw), idx, trans


class KNNPartClassifier:
    """k-NN classifier over cached part-feature banks.

    Replaces the reference's sklearn k-NN over DINO features
    (structure/utils.py:499-528): given a bank of (feature, part-label)
    pairs, classifies query features by majority vote among the k nearest
    neighbours.  Pure NumPy.
    """

    def __init__(self, features: np.ndarray, labels: np.ndarray, k: int = 5):
        self.features = np.asarray(features, np.float32)
        self.labels = np.asarray(labels)
        self.k = min(k, len(self.labels))

    def predict(self, queries: np.ndarray) -> np.ndarray:
        q = np.asarray(queries, np.float32)
        d2 = ((q[:, None, :] - self.features[None, :, :]) ** 2).sum(-1)
        nn = np.argsort(d2, axis=1)[:, : self.k]
        out = np.empty(len(q), self.labels.dtype)
        for i, row in enumerate(nn):
            vals, counts = np.unique(self.labels[row], return_counts=True)
            out[i] = vals[np.argmax(counts)]
        return out

    @classmethod
    def from_file(cls, path: str, k: int = 5):
        """Load a cached feature bank (.npz with 'features', 'labels')."""
        d = np.load(path)
        return cls(d["features"], d["labels"], k=k)


def relabel_feature_bank(path: str, out_path: str, old_to_new: dict):
    """Remap part ids in a cached feature bank (the reference's one-off
    structure/test.py relabel script)."""
    d = dict(np.load(path))
    labels = d["labels"]
    d["labels"] = np.vectorize(lambda x: old_to_new.get(int(x), int(x)))(labels)
    np.savez(out_path, **d)


def estimate_joint_angle(xyz_a: np.ndarray, xyz_b: np.ndarray, seed: int = 0,
                         method: str = "ransac", device="cuda"):
    """Two-frame revolute joint estimation (structure/gapartnet.py:819-963):
    fit a rigid rotation between the two part clouds on `device`, then take
    the axis (the eigenvector of R for eigenvalue 1), the angle and a pivot
    from the least-squares fixed-point equation.  `method`:

    * "ransac": a direct Umeyama fit on index-paired points (the two frames
      must be roughly correspondence-ordered; the reference's
      RANSAC-Umeyama branch, :848);
    * "cpd": correspondence-free Coherent Point Drift (ops/cpd.rigid_cpd,
      the reference's pycpd branch, :861), for independent samples of the
      part surface.

    `seed` is unused (kept for the JAX package's signature).  Returns
    dict(axis (3,), angle_rad, pivot (3,), rotation (3, 3))."""
    m = min(len(xyz_a), len(xyz_b))
    a = torch.from_numpy(np.ascontiguousarray(xyz_a[:m], dtype=np.float32)).to(device)
    b = torch.from_numpy(np.ascontiguousarray(xyz_b[:m], dtype=np.float32)).to(device)
    if method == "cpd":
        # CPD aligns the moving cloud onto the target: frame a -> frame b
        _, rot, trans, _ = rigid_cpd(b, a)
    else:
        _, rot, trans = umeyama_masked(a, b, torch.ones(m, dtype=torch.bool, device=a.device))
    r = rot.cpu().numpy().astype(np.float64)
    angle = float(np.arccos(np.clip((np.trace(r) - 1) / 2, -1, 1)))
    w, v = np.linalg.eig(r.T)
    axis = np.real(v[:, np.argmin(np.abs(w - 1))])
    axis /= np.linalg.norm(axis)
    # pivot: the fixed point of x -> x @ R + t, i.e. (I - R)^T pivot = t.
    # (I - R^T) is rank 2 (the axis is its null direction); with an
    # estimated rotation the third singular value is ~1e-7, which a default
    # rcond would invert: truncate it (the pivot's axis component is
    # unobservable)
    t = trans.cpu().numpy().astype(np.float64)
    pivot, *_ = np.linalg.lstsq(np.eye(3) - r.T, t, rcond=1e-3)
    return dict(axis=axis, angle_rad=angle, pivot=pivot, rotation=r)
