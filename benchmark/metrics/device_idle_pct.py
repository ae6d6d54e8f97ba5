"""``device_idle_pct``: the share of the traced block in which no operation
ran on the card, ``1 - union of device intervals / block``, in percent."""

import timeline


def read(trace):
    return 100.0 * timeline.idle_share(trace)
