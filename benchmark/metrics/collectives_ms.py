"""``collectives_ms``: device time of the NCCL kernels per query on this
rank (``ncclDevKernel_*``); nothing where none ran."""

import timeline


def read(trace):
    ms = timeline.device_ms(trace, lambda name: name.startswith(("ncclDevKernel", "ncclKernel")))
    return ms / trace.queries if ms else None
