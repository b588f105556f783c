"""Mask-conditioned pose requests from one client (closed loop).

The system under test is `GAPartNetInference.predict_with_masks`, built
as users build it: the eval capacities of the configuration
(`config.eval_capacity_config`), `auto_capacity`, the weights of the run's
seed, `ransac_iters` from the traffic file.  The pool holds `pool` rotated
clouds, each with its ground-truth instance masks standing in for a
segmenter's.  Set-up sends every cloud once (the capacities settle); the
window sends the pool round after round, in an order drawn from the seed,
each request after the reply to the last; a traced run sends
`trace_units` requests unprofiled and the same again under the profiler
(portbench/tracing.py).  Latency is the host clock from call to return
(the reply is on the host).  After the window a seeded sample of the
clouds' last replies (the window's, or the set-up's where the window sent
none) is compared with the plain reference.
"""

import time

import numpy as np
import torch

from portbench import cloud, compare, program, stats, tracing, weights, work
from portbench.harness import Outcome, Run
from portbench.reference import infer as ref_infer
from portbench.reference import model as ref


class Program:
    def __init__(self, run: Run, state):
        from gapartnet_tpu_torch.config import eval_capacity_config
        from gapartnet_tpu_torch.infer.api import GAPartNetInference

        cfg = eval_capacity_config(program.config(run.config["model"]))
        self.api = GAPartNetInference(cfg, state_dict=state, auto_capacity=True, device=run.device)
        self.model = self.api.model
        self.iters = run.traffic["ransac_iters"]
        self.counters, self.sem = [], {}
        self.current = None
        self.model.register_forward_hook(self._hook)

    def _hook(self, mod, args, out):
        self.counters.append(out.counters)
        self.sem[self.current] = out.sem_logits

    def request(self, i, c):
        self.current = i
        return self.api.predict_with_masks(c["points"], c["masks"], ransac_iters=self.iters)

    def counter_sum(self) -> float:
        return float(sum(float(v.sum()) for cs in self.counters for v in cs.values()))

    def sem_logits(self, i):
        return self.sem[i][0].cpu().numpy()


class Control:
    """The plain reference in the program's place (in TF32)."""

    def __init__(self, run: Run, rcfg, state):
        self.model = ref.GAPartNet(rcfg)
        self.model.load_state_dict(state, strict=True)
        self.model = self.model.to(run.device).eval()
        self.iters = run.traffic["ransac_iters"]
        self.sem = {}

    def request(self, i, c):
        sem, *rest = ref_infer.predict_with_masks(self.model, c["points"], c["masks"], self.iters)
        self.sem[i] = sem
        return tuple(rest)

    def counter_sum(self) -> float:
        return 0.0

    def sem_logits(self, i):
        return self.sem[i]


def _work(run: Run, rcfg, pool, ids):
    m = run.config["model"]
    total = {"flops": 0.0, "subm_bound_s": 0.0}
    half = torch.full((3,), 0.5, device=run.device)
    cache = {}
    for i in ids:
        if i not in cache:
            c = pool[i]
            pts = torch.as_tensor(c["points"], device=run.device)[None]
            ep, pid, nprop = ref_infer.mask_proposals(c["masks"], pts.shape[1], run.device)
            cache[i] = work.work_of(m, rcfg, pts, torch.ones(pts.shape[:2], dtype=torch.bool,
                                                             device=run.device),
                                    ep, pid, nprop, half, half, False)
        for k in total:
            total[k] += cache[i][k]
    return total


def run(run: Run) -> Outcome:
    tr = run.traffic
    m = run.config["model"]
    rcfg = ref.RefConfig.from_model(m)
    pool = cloud.make_pool(run.seed, tr["pool"], m["max_instances"], tr.get("num_points", 0))
    shapes = {k: v.shape for k, v in ref.GAPartNet(rcfg).state_dict().items()}
    state = weights.make_state(shapes, run.seed, run.device)
    if run.control:
        torch.backends.cuda.matmul.allow_tf32 = run.control == "tf32"
        torch.backends.cudnn.allow_tf32 = run.control == "tf32"
        system = Control(run, rcfg, state)
    else:
        system = Program(run, state)
    del state
    # each cloud's last reply: the set-up's, until the window replaces it
    last, lat = {}, []
    for i, c in enumerate(pool):
        last[i] = system.request(i, c)
    sync = torch.cuda.synchronize if run.device == "cuda" else (lambda: None)
    sync()
    setup_s = time.perf_counter() - run.t_start

    rng = np.random.default_rng(run.seed % (2 ** 63))
    order = rng.permutation(len(pool))
    trace = None
    if run.trace:
        units = run.cell["trace_units"]
        ids = [int(order[k % len(pool)]) for k in range(units)]

        def requests(unit_span):
            for i in ids:
                with unit_span():
                    last[i] = system.request(i, pool[i])
            return units

        trace = tracing.traced_stretch(requests, dict(system.model.named_children()),
                                       system.model.backbone)
    else:
        start = time.perf_counter()
        k = 0
        while time.perf_counter() - start < run.seconds:
            i = int(order[k % len(pool)])
            t0 = time.perf_counter()
            last[i] = system.request(i, pool[i])
            lat.append(time.perf_counter() - t0)
            k += 1
    peak = torch.cuda.max_memory_allocated() if run.device == "cuda" else 0
    counters = system.counter_sum()
    sample = sorted(int(i) for i in rng.choice(sorted(last), min(tr["compared"], len(last)),
                                               replace=False))
    sem = {i: system.sem_logits(i) for i in sample}
    del system
    if run.device == "cuda":
        torch.cuda.empty_cache()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    state = weights.make_state(shapes, run.seed, run.device)
    judge = ref.GAPartNet(rcfg)
    judge.load_state_dict(state, strict=True)
    judge = judge.to(run.device).eval()
    del state
    values = {"sem": 0.0, "scores": 0.0, "npcs": 0.0, "boxes": 0.0, "counters": counters}
    for i in sample:
        c = pool[i]
        r_sem, r_scores, _, r_npcs, r_boxes = ref_infer.predict_with_masks(
            judge, c["points"], c["masks"], tr["ransac_iters"])
        scores, _, npcs, boxes = last[i]
        # NPCS where both sides pick the same class's head (a sem near-tie
        # may tip the pick; the sem logits are judged under `sem`)
        on = c["masks"].any(axis=0) & (sem[i].argmax(-1) == r_sem.argmax(-1))
        values["sem"] = max(values["sem"], compare.rel_gap(sem[i], r_sem))
        values["scores"] = max(values["scores"], float(np.abs(scores - r_scores).max()))
        values["npcs"] = max(values["npcs"], float(np.abs(npcs - r_npcs)[on].max()))
        values["boxes"] = max(values["boxes"], compare.box_gap(boxes, r_boxes))
    del judge
    metrics = {"setup_s": setup_s}
    if lat:
        metrics.update(request_ms_p50=stats.percentile(lat, 50) * 1e3,
                       request_ms_p95=stats.percentile(lat, 95) * 1e3)
    if trace is not None:
        trace.work = _work(run, rcfg, pool, ids)
        trace.untraced_work = dict(trace.work)     # both stretches send `ids`
    return Outcome(attempted=len(lat) if trace is None else trace.untraced_units + trace.units,
                   failed=0,
                   metrics=metrics, compared=compare.judged(values, run.cell["limits"]),
                   memory_peak_bytes=peak, trace=trace,
                   notes={"requests": len(lat), "compared_clouds": sample})
