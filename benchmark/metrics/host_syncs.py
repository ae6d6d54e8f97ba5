"""``host_syncs``: the host's waits for the device (stream, device and event
synchronisations, synchronous copies; a device-to-host read is one), per
query, the harness's own end-of-query synchronize left out."""

import timeline


def read(trace):
    return timeline.host_syncs(trace)
