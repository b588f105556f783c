"""The submanifold conv kernels' share of their roofline, in %: the least
time the stretch's subm convs need (portbench/work.py: each conv's
operations at the fp32-accurate peak or its bytes at the HBM rate,
whichever is larger) over the device time of the program's subm conv
kernels, found by name, both from the profiled stretch.  One reader for
`subm_conv_roofline.train` and `subm_conv_roofline.request`."""

import re

KERNELS = re.compile(r"subm_conv|sum_splits_kernel|sum_chunks_kernel")


def read(trace):
    if trace is None or not trace.work.get("subm_bound_s"):
        return None
    device_s = trace.device_seconds(KERNELS)
    if device_s <= 0:
        return None
    return 100.0 * trace.work["subm_bound_s"] / device_s
