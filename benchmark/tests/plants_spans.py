"""The program as it was before its spans, planted in the process of a run
for ``test_bench_spans.py``: nothing records, and the recorder's module
cannot be imported, as in a checkout that lacks it."""

import sys


def no_spans():
    from vivit_tpu_torch import eigdc, structured, tapped  # noqa: F401  (bound to the recorder)
    from vivit_tpu_torch.kernels import jacobi  # noqa: F401
    from vivit_tpu_torch.utils import trace

    trace.enable(False)
    del sys.modules["vivit_tpu_torch.utils"].trace
    sys.modules["vivit_tpu_torch.utils.trace"] = None
