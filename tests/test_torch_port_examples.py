"""The port's examples (``examples_torch/example_*.py``) run as scripts, on
the CPU here (each picks the CUDA card when there is one).  The heavy
``example_fast_eigensolver`` and ``example_data_parallel`` (it spawns a
process group) carry the ``slow`` marker, as their JAX twins do in
``tests/test_examples.py``."""

import pathlib
import runpy

import pytest
import torch

EXAMPLES = sorted(
    (pathlib.Path(__file__).parent.parent / "examples_torch").glob("example_*.py"))
_HEAVY = {"example_fast_eigensolver", "example_data_parallel"}
EXAMPLES = [pytest.param(p, marks=pytest.mark.slow) if p.stem in _HEAVY else p
            for p in EXAMPLES]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The suite runs several worker processes at once: torch's intra-op
    thread pool in each would oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("script", EXAMPLES,
                         ids=lambda p: p.stem if hasattr(p, "stem") else None)
def test_example_runs(script):
    runpy.run_path(str(script), run_name="__main__")
