"""Faults planted in the program for ``test_bench_faults.py``: each function
patches ``vivit_tpu_torch`` in the process of a run (every rank), below the
harness, which then has to find the answers wrong."""

import types


def _wrap_spectra(make):
    """Replace both spectrum entries by ``make(original)``'s function of
    ``(X, y, call)``; ``call(X, y)`` runs the original."""
    import vivit_tpu_torch as vtt
    from vivit_tpu_torch import parallel

    single = vtt.eigvalsh_structured

    def eigvalsh_structured(model, loss, X, y, **kw):
        return make(X, y, lambda X_, y_: single(model, loss, X_, y_, **kw))

    vtt.eigvalsh_structured = eigvalsh_structured
    builder = parallel.eigvalsh_dp_structured

    def eigvalsh_dp_structured(*args, **kw):
        fn = builder(*args, **kw)
        return lambda X_l, y_l, key=None: make(X_l, y_l, lambda X_, y_: fn(X_, y_, key))

    parallel.eigvalsh_dp_structured = eigvalsh_dp_structured


def stale():
    """Every answer is the first one the program gave: the query's state
    is never updated by the new batch."""
    first = []

    def make(X, y, call):
        out = call(X, y)
        if not first:
            first.append(out)
        return first[0]

    _wrap_spectra(make)


def half_batch():
    """Half of the batch left out: the second half replaced by the first, so
    that the mean runs over the first half alone."""
    def make(X, y, call):
        h = X.shape[0] // 2
        return call(X[:h].repeat(2, *[1] * (X.dim() - 1)), y[:h].repeat(2))

    _wrap_spectra(make)


def altered():
    """The answer altered where it is produced: the eigensolver's
    eigenvalues one percent high."""
    from vivit_tpu_torch import eig

    full_eigh = eig.full_eigh

    def altered_eigh(*args, **kwargs):
        evals, *rest = full_eigh(*args, **kwargs)
        return (evals * 1.01, *rest)

    eig.full_eigh = altered_eigh


def exchange_left_out():
    """The exchange between ranks left out: every collective of the
    program's data parallelism returns this rank's own data."""
    from vivit_tpu_torch import parallel

    real = parallel.dist

    def all_gather(out, t, group=None):
        for o in out:
            o.copy_(t)

    def all_to_all_single(recv, send, group=None):
        recv.copy_(send)

    parallel.dist = types.SimpleNamespace(
        all_gather=all_gather, all_to_all_single=all_to_all_single,
        all_reduce=lambda t, group=None: None,
        is_available=real.is_available, get_rank=real.get_rank, get_world_size=real.get_world_size,
        is_initialized=real.is_initialized, get_backend=real.get_backend)
