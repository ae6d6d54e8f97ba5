"""``generic_vt_params``: parameters (their elements) that the program's
tapped engine sent to its generic engine (``tapped.GENERIC_PARAMS``), per
query of the traced block; nothing where the program has no such counter
or the entry does not read it."""


def read(trace):
    sent = trace.counters.get("generic_params")
    return None if sent is None else sent / trace.queries
