"""The whole unit's model FLOPs (portbench/work.py: every matmul layer at
the rows its inputs need) over the wall time of the trace run's unprofiled
stretch, as a share of the H100's fp32-accurate tensor-core peak (3xTF32,
495/3 TFLOP/s), in %.  One reader for `mfu_pct.train` and `mfu_pct.request`."""

from portbench.work import PEAK_FP32_ACCURATE_FLOPS


def read(trace):
    if trace is None or trace.untraced_s <= 0 or not trace.untraced_work.get("flops"):
        return None
    return 100.0 * trace.untraced_work["flops"] / (trace.untraced_s * PEAK_FP32_ACCURATE_FLOPS)
