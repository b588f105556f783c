"""Training steps back to back with the published grouping: the first-K
ball query and CCL (`clustering_impl: "exact"`).

The closed loop, the pool, the weights, the checked steps, the judge and
the numbers it compares are portbench/traffic/train_steps.py's, imported
from it.  Only the grouping differs, and with it three things:

  * the program's capacities: its own rules for exact clustering, as
    `entry.bench_cloud_setup` applies them, the largest over the pool:
    `entry._fitted_capacities`, then `entry._exact_proposals` (the
    proposal cap and the dense pool from the proposals that the exact
    clustering of each cloud under the overrides keeps);
  * the reference's proposals: portbench/reference/exact.py groups each
    batch once (the ground-truth labels and offsets drive the grouping, so
    a batch's proposals do not change from step to step) and the reference
    model takes them as `proposals=`;
  * the work a step needs (portbench/work.py, for `mfu_pct.*` and the subm
    conv roofline): the proposal grids of those proposals.

And one number more decides `correct`: `grouping`, the gap between what the
program's ball queries list in the first step (rows whose hits reached K,
neighbours listed, the sum of their indices, as its recorder counts them)
and what the reference's list for the same batch.  The proposals alone
cannot show a wrong K or a wrong choice of K: on this traffic no xyz row
has more than 33 same-label hits, and on xyz + offsets any K >= 1 links an
instance.  A program that counts none of the three reads 0 here, and the
line's notes say so.
"""

import dataclasses
import time

import torch

from portbench import cloud, compare, program, tracing, weights, work
from portbench.harness import Outcome, Run
from portbench.reference import exact
from portbench.reference import model as ref
from portbench.traffic import train_steps as steps

# the program's counts of what its ball queries list, held against the reference's
GROUPING_COUNTS = ("ball_query_full_rows", "ball_query_hits", "ball_query_index_sum")


class Program(steps.Program):
    """The program's train step with exact clustering, at the capacities its
    exact-clustering rules give."""

    def __init__(self, run: Run, pool, batches, state):
        from gapartnet_tpu_torch.entry import _exact_proposals, _fitted_capacities, max_fitted
        from gapartnet_tpu_torch.entry import use_fp32_math
        from gapartnet_tpu_torch.models.gapartnet import GAPartNet
        from gapartnet_tpu_torch.structures import PointCloudBatch
        from gapartnet_tpu_torch.train import loop

        use_fp32_math()
        cfg = program.config(run.config["model"])
        fitted = []
        for c in pool:
            xyz = c["points"][:, :3]
            fields, _ = _fitted_capacities(cfg, xyz, c["sem_labels"], c["instance_labels"])
            fields.update(_exact_proposals(cfg, xyz, c["sem_labels"], c["cluster_offsets"], run.device))
            fitted.append(fields)
        self.cfg = dataclasses.replace(cfg, **max_fitted(fitted))
        self.model = GAPartNet(self.cfg)
        self.model.load_state_dict(state, strict=True)
        self.model = self.model.to(run.device).train()
        self.loop = loop
        self.opt = loop.adam(self.model.named_parameters(), run.traffic["learning_rate"])
        self.gen = torch.Generator().manual_seed(steps.jitter_seed(run.seed))
        self.batches = [(PointCloudBatch.from_numpy(b, run.device),
                         torch.as_tensor(b["sem_labels"], device=run.device),
                         torch.as_tensor(b["cluster_offsets"], device=run.device)) for b in batches]
        self.steps = 0
        self.first = None
        self._hook = self.model.register_forward_hook(self._capture)
        self.listed = None

    def step(self):
        """A train step; the first under the program's recorder, whose
        ball-query counts it keeps in `listed` (None where the program
        counts none of them)."""
        from gapartnet_tpu_torch.utils import profiling

        if self.steps or not hasattr(profiling, "record"):
            return super().step()
        with profiling.record() as rec:
            metrics = super().step()
        self.listed = {k: rec.counts[k] for k in GROUPING_COUNTS if k in rec.counts} or None
        return metrics


class Reference(steps.Reference):
    """The plain reference's step on the proposals of the exact grouping."""

    def __init__(self, run: Run, rcfg, batches, state, proposals):
        super().__init__(run, rcfg, batches, state)
        self.proposals = proposals

    def step(self):
        i = self.steps % len(self.batches)
        b = self.batches[i]
        self.steps += 1
        self.model.train()
        out = self.model(b["points"], b["point_mask"], labels=b, jitter=steps.draw_jitter(self.gen),
                         proposals=self.proposals[i])
        out["total_loss"].backward()
        self.opt.step()
        if self.first is None:
            self.first = {k: out[k].detach() for k in ("sem_logits", "offset_preds", "entry_pid",
                                                        "score_logits", "npcs_preds")}
            self.first["num_proposals"] = torch.tensor(out["num_proposals"])
        return {f"loss/{k}": out[k].detach() for k in out if k.startswith("loss_") or k == "total_loss"}


def reference_proposals(run: Run, batches):
    """Each batch's proposals by the plain exact grouping, on the device,
    and what its ball queries list (`exact.ball_query_counts`): the points
    the reference clusters in training are the labelled foreground ones."""
    proposals, listed = [], []
    for b in batches:
        t = {k: torch.as_tensor(b[k], device=run.device)
             for k in ("points", "point_mask", "sem_labels", "instance_labels", "cluster_offsets")}
        valid = (t["sem_labels"] > 0) & t["point_mask"] & (t["instance_labels"] >= 0)
        props, counts = exact.batch_proposals(t["points"], t["cluster_offsets"], t["sem_labels"],
                                              valid, run.config["model"])
        proposals.append(props)
        listed.append(counts)
    return proposals, listed


def grouping_gap(program_listed, reference_listed) -> float:
    """The summed absolute gaps of the first step's ball-query counts; 0
    where the program counts none of them."""
    if program_listed is None:
        return 0.0
    return float(sum(abs(program_listed.get(k, 0) - reference_listed[k]) for k in GROUPING_COUNTS))


def _work_per_step(run: Run, rcfg, batches, proposals, step_ids):
    """Operations and subm-conv bound of each of the given step indices."""
    gen = torch.Generator().manual_seed(steps.jitter_seed(run.seed))
    draws = [steps.draw_jitter(gen) for _ in range(max(step_ids) + 1)]
    total = {"flops": 0.0, "subm_bound_s": 0.0}
    for s in step_ids:
        bi = s % len(batches)
        points = torch.as_tensor(batches[bi]["points"], device=run.device)
        mask = torch.as_tensor(batches[bi]["point_mask"], device=run.device)
        ep, pid, nprop = proposals[bi]
        j = draws[s].to(run.device)
        w = work.work_of(run.config["model"], rcfg, points, mask, ep, pid, nprop, j[0], j[1], True)
        for k in total:
            total[k] += w[k]
    return total


def run(run: Run) -> Outcome:
    tr = run.traffic
    m = run.config["model"]
    rcfg = ref.RefConfig.from_model(m)
    bsz = tr["batch"]
    pool = cloud.make_pool(run.seed, bsz * tr["pool_batches"], m["max_instances"], tr.get("num_points", 0))
    batches = [cloud.stack(pool[i * bsz:(i + 1) * bsz]) for i in range(tr["pool_batches"])]
    shapes = {k: v.shape for k, v in ref.GAPartNet(rcfg).state_dict().items()}
    state = weights.make_state(shapes, run.seed, run.device)
    if run.control:
        torch.backends.cuda.matmul.allow_tf32 = run.control == "tf32"
        torch.backends.cudnn.allow_tf32 = run.control == "tf32"
        system = Reference(run, rcfg, batches, state, reference_proposals(run, batches)[0])
    else:
        system = Program(run, pool, batches, state)
    del state
    losses, outs, g1, change, metrics = steps.drive(system, tr["checked_steps"])
    sync = torch.cuda.synchronize if run.device == "cuda" else (lambda: None)
    sync()
    setup_s = time.perf_counter() - run.t_start

    trace = None
    first_window_step = system.steps
    if run.trace:
        units = run.cell["trace_units"]

        def run_steps(unit_span):
            for _ in range(units):
                with unit_span():
                    metrics.append(system.step())
            return units

        trace = tracing.traced_stretch(run_steps, dict(system.model.named_children()),
                                       system.model.backbone)
        window_steps = trace.untraced_units + trace.units
        wall = trace.untraced_s + trace.window_s
    else:
        start = time.perf_counter()
        window_steps = 0
        while time.perf_counter() - start < run.seconds:
            metrics.append(system.step())
            window_steps += 1
        sync()
        wall = time.perf_counter() - start
    peak = torch.cuda.max_memory_allocated() if run.device == "cuda" else 0
    counters = sum(float(v) for mt in metrics for k, v in mt.items() if k.startswith("counters/"))
    losses = [float(x) for x in losses]
    first_loss = steps.judged_loss(metrics[0])
    outs = steps._to_cpu(outs)
    listed = getattr(system, "listed", None)
    del system, metrics
    if run.device == "cuda":
        torch.cuda.empty_cache()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    # the judge: the plain reference in fp32, on the plain exact grouping's
    # proposals, through the same first steps
    proposals, r_listed = reference_proposals(run, batches)
    state = weights.make_state(shapes, run.seed, run.device)
    judge = Reference(run, rcfg, batches, state, proposals)
    del state
    r_losses, r_outs, r_g1, r_change, r_metrics = steps.drive(judge, tr["checked_steps"])
    r_losses = [float(x) for x in r_losses]
    r_first_loss = steps.judged_loss(r_metrics[0])
    r_outs = steps._to_cpu(r_outs)
    del judge
    values = {
        "loss": abs(first_loss - r_first_loss) / max(abs(r_first_loss), 1e-30),
        "grad": compare.leaf_norm_gap(g1, r_g1, r_g1),
        "change": compare.leaf_norm_gap(change, r_change, r_g1),
        "counters": counters,
        "grouping": grouping_gap(listed, r_listed[0]),
    }
    values.update(steps._output_gaps(outs, r_outs))
    notes = {"losses": losses, "reference_losses": r_losses, "window_steps": window_steps,
             "total_loss_gap": abs(losses[0] - r_losses[0]) / max(abs(r_losses[0]), 1e-30),
             "first_window_step": first_window_step,
             "reference_proposals": [nprop for _, _, nprop in proposals],
             "listed": listed, "reference_listed": r_listed[0],
             "worst_grad_leaves": compare.worst_leaves(g1, r_g1, r_g1),
             "worst_change_leaves": compare.worst_leaves(change, r_change, r_g1),
             "loss_gap_all_steps": max(abs(a - b) / max(abs(b), 1e-30)
                                       for a, b in zip(losses, r_losses)),
             "change_gap_median_leaf": compare.median_leaf_gap(change, r_change, r_g1)}
    if trace is not None:
        plain = first_window_step + trace.untraced_units
        trace.untraced_work = _work_per_step(run, rcfg, batches, proposals,
                                             list(range(first_window_step, plain)))
        trace.work = _work_per_step(run, rcfg, batches, proposals,
                                    list(range(plain, plain + trace.units)))
    return Outcome(attempted=window_steps, failed=0,
                   metrics={"train_clouds_per_s": bsz * window_steps / wall, "setup_s": setup_s},
                   compared=compare.judged(values, run.cell["limits"]),
                   memory_peak_bytes=peak, trace=trace, notes=notes)
