"""``kernel_roofline``: the fixed roofline of one request over the device
time per request of the program's kernels in the traced segment, in %."""


def read(rec):
    """None where the trace saw none of the program's kernels."""
    tr = rec.trace
    if tr is None or tr.port_kernel_s <= 0 or tr.requests <= 0:
        return None
    return 100.0 * rec.bound_s / (tr.port_kernel_s / tr.requests)
