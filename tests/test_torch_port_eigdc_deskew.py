"""The 4-term de-skew routes of ``eigh_dc`` against the JAX package called
with the same keywords and against float64, at n=512 in both modes:
``deskew_terms=4`` through the ladder's root, and with ``ladder=False`` the
deep map's root (the pre-strip design, whose root takes 4 terms on its own
at n ≥ 2048).  :func:`check_route` is in ``test_torch_port_eigdc_routes.py``.
"""

import pytest
import torch

from tests.test_torch_port_eigdc_routes import check_route

KNOBS = {"ladder root": {"deskew_terms": 4},
         "deep-map root": {"deskew_terms": 4, "ladder": False}}
CASES = [(name, vectors) for name in KNOBS for vectors in (False, True)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several worker processes at once: torch's intra-op
    thread pool in each would oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("route,vectors", CASES,
                         ids=[f"{r}-{'eigenpairs' if v else 'eigenvalues'}" for r, v in CASES])
def test_four_term_deskew_matches_jax_and_f64(route, vectors):
    check_route(512, KNOBS[route], vectors)
