"""Card-vs-CPU parity of the inference API's requests: the rules that
chip_smoke.py holds the card to.

The same request runs on the card and on the CPU with the same weights and
the same CPU-drawn RANSAC samples.  Integers must be equal; floats within
stated tolerances of scale.  Where the card's sem_preds flip at a near-tie
of the two largest logits, or an offset within tolerance moves a shifted
point into another hash cell, the integers that follow differ, and
`compare_requests` holds them by a CPU replay of the card's own outputs.
Each check prints its line and raises AssertionError when it fails.
"""

import time

import numpy as np
import torch

from gapartnet_tpu_torch.ops.voxelize import div_const

# card vs CPU forward: fp32 through ~60 conv layers, sums in other orders
FORWARD_RTOL = 1e-4
# dense proposal cells may move by one cell on at most this share of entries
CELL_FLIP_SHARE = 1e-3
# card vs CPU requests: NPCS and scores as the forward's floats; the ok
# boxes, scales, rotations and translations within 1e-3 of scale (a refit
# sums up to thousands of rows and takes a 3x3 SVD, cuSOLVER against LAPACK)
NPCS_RTOL = FORWARD_RTOL
BOX_RTOL = 1e-3


def check_close(name, got, want, mask=None, rtol=FORWARD_RTOL, allow=0.0):
    """max|got - want| <= rtol * max|want| + allow (over `mask`)."""
    got, want = got.cpu(), want.cpu()
    if mask is not None:
        got, want = got[mask], want[mask]
    if got.numel() == 0:
        print(f"[compare] {name}: nothing to compare")
        return
    err = float((got - want).abs().max())
    scale = max(float(want.abs().max()), 1e-30)
    print(f"[compare] {name}: max|d| {err:.3e}, max|cpu| {scale:.3e}, n={got.numel()}"
          + (f", probe allowance {allow:.3e}" if allow else ""))
    if not err <= rtol * scale + allow:
        raise AssertionError(f"{name}: card vs CPU max|d| {err} > {rtol} * {scale} + {allow}")


def check_equal(name, got, want):
    """`got` equal to `want`, element for element."""
    if not torch.equal(got.cpu(), want.cpu()):
        n = int((got.cpu() != want.cpu()).sum())
        raise AssertionError(f"{name}: card and CPU differ at {n} entries")


def near_ties(name, got, want_logits, tol=None):
    """sem_preds may differ only where the CPU's two largest logits are
    within the forward's tolerance (or `tol`) of each other."""
    want = want_logits.argmax(dim=-1)
    flip = got != want
    if flip.any():
        top2 = want_logits[flip].topk(2, dim=-1).values
        tol = FORWARD_RTOL * float(want_logits.abs().max()) if tol is None else tol
        if not bool(((top2[:, 0] - top2[:, 1]) <= 2 * tol).all()):
            raise AssertionError(f"{name}: sem_preds differ at a point that is not a near-tie")
    return int(flip.sum())


def cpu_post(cpu, pts, out, keep_given):
    """The stages after the forward on the CPU, from given forward outputs
    (the card's, copied to the CPU)."""
    keep = cpu._select(out) if keep_given is None else keep_given
    result, jobs = cpu._scatter(pts, out, keep, 10)
    fits = cpu._fit(jobs, 100, 0) if jobs is not None else None
    return keep, result, jobs, fits


def cluster_replay(tag, got, cpu, pts, want, differ):
    """sem_preds agree, yet the clustering's integers differ (`differ`).  The
    hash clustering cuts the shifted set xyz + offset_preds into cells of
    side radius / sqrt(3) and joins nodes by a radius test, so an offset
    within the forward's tolerance of a cell face or of the radius moves a
    point; where the node table overflows (the default capacity on a whole
    cloud) one node more or less changes the overflow count and which nodes
    are kept.  The card's offsets must lie within FORWARD_RTOL of the CPU's;
    at most CELL_FLIP_SHARE of the valid shifted points may change cell, and
    at least one where the node overflow differs; and a CPU forward that
    clusters the card's sem_preds and offsets (its heads its own) must give
    the card's counters and proposals exactly.  Returns that CPU forward."""
    print(f"[{tag} compare] clustering integers differing with sem_preds equal: "
          f"{', '.join(differ)}")
    n = len(pts)
    card_offs = got.offset_preds[0, :n].cpu()
    check_close(f"{tag}: offset_preds", card_offs, want.offset_preds[0, :n])
    xyz = torch.from_numpy(np.ascontiguousarray(pts[:, :3]))
    valid = (want.sem_preds[0, :n] > 0).repeat(2)
    side = cpu.cfg.ball_query_radius / 3.0 ** 0.5
    cells = []
    for offs in (card_offs, want.offset_preds[0, :n]):
        both = torch.cat([xyz, xyz + offs])
        lo = torch.where(valid[:, None], both, torch.tensor(1e9)).amin(dim=0) - side
        cells.append(torch.floor(div_const(both - lo, side)))
    moved = int(((cells[0] != cells[1]).any(dim=-1) & valid).sum())
    n_valid = int(valid.sum())
    print(f"[{tag} compare] points of the two sets in another hash cell on the card: {moved} of "
          f"{n_valid}")
    if moved > CELL_FLIP_SHARE * n_valid:
        raise AssertionError(f"{tag}: {moved} shifted points changed hash cell "
                             f"(> {CELL_FLIP_SHARE:.1%})")
    if moved == 0 and "counter ccl_node_overflow" in differ:
        raise AssertionError(f"{tag}: the node overflow differs with no point in another cell")
    with torch.no_grad():
        ref = cpu.model(cpu._wrap_points(pts), do_cluster=True, do_score=True, do_npcs=True,
                        cluster_sem_override=got.sem_preds.cpu(),
                        cluster_offset_override=got.offset_preds.cpu())
    what = "(CPU clustering of the card's sem_preds and offsets)"
    for k, v in ref.counters.items():
        check_equal(f"{tag}: counter {k} {what}", got.counters[k], v)
    for f in ref.proposals._fields:
        check_equal(f"{tag}: proposals.{f} {what}", getattr(got.proposals, f),
                     getattr(ref.proposals, f))
    print(f"[{tag} compare] counters and proposals equal the CPU's clustering of the card's "
          "sem_preds and offsets")
    return ref


def compare_requests(tag, card_req, cpu, pts, proposals_cpu=None):
    """The same request on the CPU (same weights, same CPU-drawn RANSAC
    samples): exact sem_preds, counters, proposals, kept proposal ids,
    ins_preds, classes, box jobs, inlier masks, ok flags; NPCS and scores
    within NPCS_RTOL of scale; boxes, scales, rotations and translations of
    the ok fits within BOX_RTOL of scale.  If sem_preds differ (allowed only
    at near-ties of the top two logits, which then change the clustering),
    the stages after the forward run on the CPU from the card's forward
    outputs and are held to the same rules, and an independent CPU forward
    on the card's proposals holds the card's scores and NPCS (except where a
    flipped point picks the class) and counters.  If sem_preds agree but the
    clustering's counters or proposals differ, `cluster_replay` explains
    them by the offsets, and the stages after the forward run on the CPU
    from its forward.  Returns how the forward's integers were held:
    "exact", "near-ties" or "replay"."""
    t0 = time.perf_counter()
    c = cpu._request(pts, proposals_cpu)
    print(f"[{tag} compare] CPU request {time.perf_counter() - t0:.1f} s")
    g = card_req
    how = "exact"
    flips = near_ties(tag, g.out.sem_preds.cpu(), c.out.sem_logits)
    print(f"[{tag} compare] sem_preds differing: {flips} of {c.out.sem_preds.numel()}")
    if flips:
        from gapartnet_tpu_torch.train.trainer import cpu_tree

        prop = cpu_tree(g.out.proposals)
        ref = cpu._forward(pts, prop)
        for k, v in ref.counters.items():
            check_equal(f"{tag}: counter {k} (CPU forward on the card's proposals)",
                         g.out.counters[k], v)
        flip = (g.out.sem_preds.cpu() != ref.sem_preds)[0]
        same_class = prop.proposal_mask[0] & (g.out.proposal_sem.cpu() == ref.proposal_sem)[0]
        same_entry = prop.entry_mask[0] & ~flip[prop.entry_point[0].long()]
        check_close(f"{tag}: score_preds (CPU forward on the card's proposals)",
                     g.out.score_preds[0], ref.score_preds[0], mask=same_class, rtol=NPCS_RTOL)
        check_close(f"{tag}: npcs_preds (CPU forward on the card's proposals)",
                     g.out.npcs_preds[0], ref.npcs_preds[0], mask=same_entry, rtol=NPCS_RTOL)
        keep_given = None if proposals_cpu is None else proposals_cpu.proposal_mask[0]
        out = cpu_tree(g.out)
        keep, result, jobs, fits = cpu_post(cpu, pts, out, keep_given)
        c = c._replace(out=out, keep=keep, result=result, jobs=jobs, fits=fits)
        how = "near-ties"
        print(f"[{tag} compare] the stages after the forward compared from the card's forward "
              "outputs")
    else:
        differ = [f"counter {k}" for k, v in c.out.counters.items()
                  if not torch.equal(g.out.counters[k].cpu(), v.cpu())]
        differ += [f"proposals.{f}" for f in c.out.proposals._fields
                   if not torch.equal(getattr(g.out.proposals, f).cpu(),
                                      getattr(c.out.proposals, f).cpu())]
        if differ and proposals_cpu is not None:
            raise AssertionError(f"{tag}: {', '.join(differ)} differ with the proposals given")
        if differ:
            out = cluster_replay(tag, g.out, cpu, pts, c.out, differ)
            keep, result, jobs, fits = cpu_post(cpu, pts, out, None)
            c = c._replace(out=out, keep=keep, result=result, jobs=jobs, fits=fits)
            how = "replay"
            print(f"[{tag} compare] the stages after the forward compared from that CPU forward")
    check_equal(f"{tag}: kept proposals", g.keep, c.keep)
    gr, cr = g.result, c.result
    for f in ("sem_preds", "ins_preds", "proposal_classes"):
        check_equal(f"{tag}: {f}", torch.from_numpy(np.asarray(getattr(gr, f))),
                     torch.from_numpy(np.asarray(getattr(cr, f))))
    for f in ("npcs_map", "proposal_scores"):
        check_close(f"{tag}: {f}", torch.from_numpy(getattr(gr, f)), torch.from_numpy(getattr(cr, f)),
                     rtol=NPCS_RTOL)
    if (g.jobs is None) != (c.jobs is None):
        raise AssertionError(f"{tag}: box jobs on one device only")
    if c.jobs is None:
        print(f"[{tag} compare] no box jobs")
        return how
    for f in ("mask", "owner"):
        check_equal(f"{tag}: jobs.{f}", torch.from_numpy(getattr(g.jobs, f)),
                     torch.from_numpy(getattr(c.jobs, f)))
    check_equal(f"{tag}: ok flags", g.fits.ok, c.fits.ok)
    check_equal(f"{tag}: inlier masks", g.fits.inlier_mask, c.fits.inlier_mask)
    ok = c.fits.ok.cpu()
    for f in ("bbox", "scale", "rotation", "translation"):
        check_close(f"{tag}: fits.{f} (ok fits)", getattr(g.fits, f).cpu()[ok],
                     getattr(c.fits, f)[ok], rtol=BOX_RTOL)
    print(f"[{tag} compare] card and CPU agree: integers exactly, NPCS and scores within "
          f"{NPCS_RTOL}, {int(ok.sum())} ok boxes within {BOX_RTOL} of scale")
    return how
