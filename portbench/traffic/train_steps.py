"""Training steps back to back, as the trainer runs them (closed loop).

The system under test is the program's `train.loop.train_step` on one
model and one Adam, built once: all three stages on, the clustering driven
by the ground-truth labels and the offsets to the instance centres (the
load a trained head gives), the cube jitter drawn every step from a CPU
generator seeded from the run's seed.  The pool holds `pool_batches`
batches of `batch` rotated clouds, stepped in turn; the program's
capacities are its own rules (`entry._fitted_capacities`, the largest over
the pool).

Set-up makes the pool and the weights, builds the step and drives it
through its first `checked_steps` steps, which warm every shape the window
uses and which the reference follows.  The window runs steps until
`--seconds` have passed and ends in a synchronize; a traced run runs
`trace_units` steps unprofiled and as many more under the profiler
(portbench/tracing.py).  Then the program's
state is freed and the plain reference takes the same first steps from the
same weights, batches and jitter.
"""

import dataclasses
import time

import torch

from portbench import cloud, compare, program, tracing, weights, work
from portbench.harness import Outcome, Run
from portbench.reference import model as ref


def draw_jitter(gen: torch.Generator) -> torch.Tensor:
    """The (2, 3) cube placement draws of one step, as the program draws them."""
    return torch.rand((2, 3), generator=gen)


def jitter_seed(seed: int) -> int:
    return (seed * 2654435761 + 1) % (2 ** 63)


class Program:
    """The program's train step on one model and optimizer."""

    def __init__(self, run: Run, pool, batches, state):
        from gapartnet_tpu_torch.entry import _fitted_capacities, max_fitted, use_fp32_math
        from gapartnet_tpu_torch.models.gapartnet import GAPartNet
        from gapartnet_tpu_torch.structures import PointCloudBatch
        from gapartnet_tpu_torch.train import loop

        use_fp32_math()
        cfg = program.config(run.config["model"])
        fitted = [_fitted_capacities(cfg, c["points"][:, :3], c["sem_labels"], c["instance_labels"])[0]
                  for c in pool]
        self.cfg = dataclasses.replace(cfg, **max_fitted(fitted))
        self.model = GAPartNet(self.cfg)
        self.model.load_state_dict(state, strict=True)
        self.model = self.model.to(run.device).train()
        self.loop = loop
        self.opt = loop.adam(self.model.named_parameters(), run.traffic["learning_rate"])
        self.gen = torch.Generator().manual_seed(jitter_seed(run.seed))
        self.batches = [(PointCloudBatch.from_numpy(b, run.device),
                         torch.as_tensor(b["sem_labels"], device=run.device),
                         torch.as_tensor(b["cluster_offsets"], device=run.device)) for b in batches]
        self.steps = 0
        self.first = None
        self._hook = self.model.register_forward_hook(self._capture)

    def _capture(self, mod, args, out):
        """The first step's outputs, kept from the forward hook."""
        p = out.proposals
        self.first = {k: v.detach() for k, v in dict(
            sem_logits=out.sem_logits, offset_preds=out.offset_preds, entry_pid=p.entry_proposal,
            score_logits=out.score_logits, npcs_preds=out.npcs_preds,
            num_proposals=p.num_proposals).items()}
        self._hook.remove()

    def step(self):
        batch, sem, off = self.batches[self.steps % len(self.batches)]
        self.steps += 1
        return self.loop.train_step(self.model, self.opt, batch, self.gen, True, True, True,
                                    cluster_sem_override=sem, cluster_offset_override=off)

    def params(self):
        return dict(self.model.named_parameters())

    def first_grads(self):
        """The first step's gradient as Adam got it: its first moment / (1 - b1)
        (zero where Adam holds no moment)."""
        return {k: self.opt.state[p].get("exp_avg", torch.zeros_like(p)) / 0.1
                for k, p in self.model.named_parameters()}


class Reference:
    """The plain reference's step, the program's stand-in in the control
    (run in TF32) and its judge."""

    def __init__(self, run: Run, rcfg, batches, state):
        self.model = ref.GAPartNet(rcfg)
        self.model.load_state_dict(state, strict=True)
        self.model = self.model.to(run.device)
        self.opt = ref.Adam(self.model.named_parameters(), run.traffic["learning_rate"])
        self.gen = torch.Generator().manual_seed(jitter_seed(run.seed))
        self.batches = [{k: torch.as_tensor(v, device=run.device) for k, v in b.items()} for b in batches]
        self.steps = 0
        self.first = None

    def step(self):
        b = self.batches[self.steps % len(self.batches)]
        self.steps += 1
        out = ref.train_step(self.model, self.opt, b, b["sem_labels"], b["cluster_offsets"],
                             draw_jitter(self.gen))
        if self.first is None:
            self.first = {k: out[k].detach() for k in ("sem_logits", "offset_preds", "entry_pid",
                                                        "score_logits", "npcs_preds")}
            self.first["num_proposals"] = torch.tensor(out["num_proposals"])
        return {f"loss/{k}": out[k].detach() for k in out if k.startswith("loss_") or k == "total_loss"}

    def params(self):
        return self.opt.params

    def first_grads(self):
        return {k: self.opt.m[k] / 0.1 for k in self.opt.params}


def _to_cpu(d):
    return {k: v.detach().cpu() if torch.is_tensor(v) else v for k, v in d.items()}


def drive(system, checked: int):
    """The first `checked` steps: (total losses, first-step outputs, first
    gradient norms, parameter-change norms, the steps' metrics)."""
    p0 = {k: p.detach().clone() for k, p in system.params().items()}
    metrics = []
    for i in range(checked):
        metrics.append(system.step())
        if i == 0:
            g1 = compare.leaf_norms(system.first_grads())
    change = compare.leaf_norms({k: p.detach() - p0[k] for k, p in system.params().items()})
    return [m["loss/total_loss"] for m in metrics], system.first, g1, change, metrics


def _work_per_step(run: Run, rcfg, batches, steps):
    """Operations and subm-conv bound of each of the given step indices."""
    m = run.config["model"]
    gen = torch.Generator().manual_seed(jitter_seed(run.seed))
    draws = [draw_jitter(gen) for _ in range(max(steps) + 1)]
    props = {}
    total = {"flops": 0.0, "subm_bound_s": 0.0}
    for s in steps:
        bi = s % len(batches)
        b = {k: torch.as_tensor(v, device=run.device) for k, v in batches[bi].items()}
        if bi not in props:
            valid = (b["sem_labels"] > 0) & b["point_mask"] & (b["instance_labels"] >= 0)
            per = [ref.cluster(b["points"][i, :, :3], b["cluster_offsets"][i], b["sem_labels"][i],
                               valid[i], rcfg) for i in range(len(valid))]
            props[bi] = (torch.stack([p for p, _ in per]), [k for _, k in per])
        pid, nprop = props[bi]
        n = b["points"].shape[1]
        ep = torch.arange(n, device=run.device).repeat(2)[None].expand(len(nprop), 2 * n)
        j = draws[s].to(run.device)
        w = work.work_of(m, rcfg, b["points"], b["point_mask"], ep, pid, nprop, j[0], j[1], True)
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
        system = Reference(run, rcfg, batches, state)
    else:
        system = Program(run, pool, batches, state)
    del state
    losses, outs, g1, change, metrics = drive(system, tr["checked_steps"])
    sync = torch.cuda.synchronize if run.device == "cuda" else (lambda: None)
    sync()
    setup_s = time.perf_counter() - run.t_start

    trace = None
    first_window_step = system.steps
    if run.trace:
        units = run.cell["trace_units"]

        def steps(unit_span):
            for _ in range(units):
                with unit_span():
                    metrics.append(system.step())
            return units

        trace = tracing.traced_stretch(steps, dict(system.model.named_children()),
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
    first_loss = judged_loss(metrics[0])
    outs = _to_cpu(outs)
    del system, metrics
    if run.device == "cuda":
        torch.cuda.empty_cache()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    # the judge: the plain reference in fp32 through the same first steps
    state = weights.make_state(shapes, run.seed, run.device)
    judge = Reference(run, rcfg, batches, state)
    del state
    r_losses, r_outs, r_g1, r_change, r_metrics = drive(judge, tr["checked_steps"])
    r_losses = [float(x) for x in r_losses]
    r_first_loss = judged_loss(r_metrics[0])
    r_outs = _to_cpu(r_outs)
    del judge
    values = {
        "loss": abs(first_loss - r_first_loss) / max(abs(r_first_loss), 1e-30),
        "grad": compare.leaf_norm_gap(g1, r_g1, r_g1),
        "change": compare.leaf_norm_gap(change, r_change, r_g1),
        "counters": counters,
    }
    values.update(_output_gaps(outs, r_outs))
    notes = {"losses": losses, "reference_losses": r_losses, "window_steps": window_steps,
             "total_loss_gap": abs(losses[0] - r_losses[0]) / max(abs(r_losses[0]), 1e-30),
             "first_window_step": first_window_step,
             "worst_grad_leaves": compare.worst_leaves(g1, r_g1, r_g1),
             "worst_change_leaves": compare.worst_leaves(change, r_change, r_g1),
             "loss_gap_all_steps": max(abs(a - b) / max(abs(b), 1e-30)
                                       for a, b in zip(losses, r_losses)),
             "change_gap_median_leaf": compare.median_leaf_gap(change, r_change, r_g1)}
    if trace is not None:
        plain = first_window_step + trace.untraced_units
        trace.untraced_work = _work_per_step(run, rcfg, batches,
                                             list(range(first_window_step, plain)))
        trace.work = _work_per_step(run, rcfg, batches, list(range(plain, plain + trace.units)))
    return Outcome(attempted=window_steps, failed=0,
                   metrics={"train_clouds_per_s": bsz * window_steps / wall, "setup_s": setup_s},
                   compared=compare.judged(values, run.cell["limits"]),
                   memory_peak_bytes=peak, trace=trace, notes=notes)


def judged_loss(metrics) -> float:
    """A step's total loss less its NPCS term.  The NPCS loss counts an
    entry only where the predicted class is the true one and reads that
    class's head, so a sem near-tie that tips one entry's argmax moves it
    by a step (the NPCS predictions are judged under `proposal_heads`,
    where both sides pick the same head)."""
    return float(metrics["loss/total_loss"]) - float(metrics["loss/loss_prop_npcs"])


def _output_gaps(p, r):
    """The first step's outputs against the reference's; a batch of
    another size than the reference's differs everywhere."""
    if p["sem_logits"].shape != r["sem_logits"].shape:
        return {"proposals": float(r["entry_pid"].numel()), "heads": 1.0, "proposal_heads": 1.0}
    pid_p, pid_r = p["entry_pid"].long(), r["entry_pid"].long()
    np_p, np_r = p["num_proposals"].long(), r["num_proposals"].long()
    props = int((pid_p != pid_r).sum()) + int((np_p != np_r).sum())
    k = min(r["score_logits"].shape[1], p["score_logits"].shape[1])
    live = torch.arange(k)[None] < np_r[:, None]
    # NPCS where both sides pick the same class's head: a sem near-tie may
    # tip the pick, and the sem logits are judged under `heads`
    same = (p["sem_logits"].argmax(-1) == r["sem_logits"].argmax(-1)).repeat(1, 2)
    return {
        "proposals": float(props),
        "heads": max(compare.rel_gap(p["sem_logits"], r["sem_logits"]),
                     compare.rel_gap(p["offset_preds"], r["offset_preds"])),
        "proposal_heads": max(compare.rel_gap(p["score_logits"][:, :k], r["score_logits"][:, :k], live),
                              compare.rel_gap(p["npcs_preds"], r["npcs_preds"], (pid_r >= 0) & same)),
    }
