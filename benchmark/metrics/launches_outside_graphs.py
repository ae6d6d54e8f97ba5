"""``launches_outside_graphs``: launches of device work (kernels, copies,
fills) by runtime calls outside ``cudaGraphLaunch``, per query."""

import timeline


def read(trace):
    return timeline.launches_outside_graphs(trace)
