"""Device time of the kernels launched under aten::convolution (the dense
proposal UNets' cuDNN convs), per request, in ms."""


def read(trace):
    if trace is None or trace.units <= 0 or trace.under_conv_s <= 0:
        return None
    return 1e3 * trace.under_conv_s / trace.units
