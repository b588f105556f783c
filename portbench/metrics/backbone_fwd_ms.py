"""The backbone's forward (the model's `backbone` module, from its input
features to its per-voxel or per-point output), CUDA events around the
module in the trace run's unprofiled stretch, mean over its calls, in ms.
One reader for `backbone_fwd_ms.train` and `backbone_fwd_ms.request`."""


def read(trace):
    if trace is None or not trace.backbone_ms:
        return None
    return sum(trace.backbone_ms) / len(trace.backbone_ms)
