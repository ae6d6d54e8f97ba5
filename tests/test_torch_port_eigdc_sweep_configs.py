"""Routes of ``tools/sweep_eigdc.py``'s configurations and the explicit
``tail_merge``, against the JAX package called with the same keywords and
against float64, at n=384: the strip below its default threshold
(``strip@n``: ``strip=256``), ``lean-combo`` (``base=256, kpm_degree=32,
sign_iters=(7, 3)``), each in both modes, and the tail merge against its
mode's default (merged in eigenvector mode, an exact tail eigh in
eigenvalues mode).  :func:`check_route` is in
``test_torch_port_eigdc_routes.py``.
"""

import pytest
import torch

from tests.test_torch_port_eigdc_routes import check_route

CASES = [
    ("strip@n", {"strip": 256}, False),
    ("strip@n", {"strip": 256}, True),
    ("lean-combo", {"base": 256, "kpm_degree": 32, "sign_iters": (7, 3)}, False),
    ("lean-combo", {"base": 256, "kpm_degree": 32, "sign_iters": (7, 3)}, True),
    ("tail_merge=True", {"tail_merge": True}, True),
    ("tail_merge=False", {"tail_merge": False}, False),
]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several worker processes at once: torch's intra-op
    thread pool in each would oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("name,kw,vectors", CASES,
                         ids=[f"{c[0]}-{'eigenpairs' if c[2] else 'eigenvalues'}"
                              for c in CASES])
def test_route_matches_jax_and_f64(name, kw, vectors):
    check_route(384, kw, vectors)
