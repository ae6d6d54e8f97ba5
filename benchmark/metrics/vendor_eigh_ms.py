"""``vendor_eigh_ms``: device time of cuSOLVER's symmetric eigensolver
kernels per query; nothing where none ran."""

import timeline

# parts of the kernel names of cuSOLVER's syevd (tridiagonal reduction,
# divide and conquer, back-transformation) and batched syevj, as they show
# in an H100 trace
NAMES = ("syevd", "syevj", "syevbj", "rotate_batch", "offa_stage", "sytrd", "sytd2",
         "symv_lo", "stedc", "steqr", "sterf", "laed", "ormtr", "ormqr", "ormql", "orgtr",
         "latrd", "larfb", "larft", "copy_info_kernel")


def read(trace):
    ms = timeline.device_ms(trace, lambda name: any(n in name.lower() for n in NAMES))
    return ms / trace.queries if ms else None
