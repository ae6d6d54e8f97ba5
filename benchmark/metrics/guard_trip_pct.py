"""``guard_trip_pct``: the share of the window's queries in which a guard
of the program's eigensolver tripped (its warning), and the query ran again
eagerly on the vendor's solver, in percent."""


def read(trace):
    return 100.0 * trace.window_trips / trace.window_queries
