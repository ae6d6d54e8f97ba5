"""``eigh_dc``'s defaults in the port: every JAX default passed
explicitly gives the result of the call with no keyword, on the chain and
the strip path, and the precision knobs, which run in full f32 whatever
they say."""

import inspect

import numpy as np
import pytest
import torch

from vivit_tpu.eigdc import eigh_dc as jax_eigh_dc

from tests.test_torch_port_eigdc_strip import N as STRIP_N
from tests.test_torch_port_eigdc_strip import _bench512_profile
from tests.test_torch_port_eigdc_strip import _spectrum_matrix
from vivit_tpu_torch.eigdc import eigh_dc, eigvalsh_dc


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several worker processes at once: torch's intra-op
    thread pool in each would oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


H384 = torch.tensor(_spectrum_matrix(np.exp(-np.linspace(0, 11, 384)) * 250.0 + 1e-7, seed=1))


def _same(a, b):
    """Two ``eigh_dc(..., return_info=True)`` results equal to the bit."""
    ev, V, info = a
    ev2, V2, info2 = b
    return (torch.equal(ev, ev2) and (V is None) == (V2 is None)
            and (V is None or torch.equal(V, V2))
            and all(torch.equal(info[k], info2[k]) for k in info))


def _jax_defaults():
    params = inspect.signature(jax_eigh_dc).parameters
    return {name: p.default for name, p in params.items()
            if name not in ("H", "eigenvectors", "return_info")}


@pytest.mark.parametrize("path,vectors", [("chain", False), ("chain", True), ("strip", False)])
def test_explicit_defaults_are_bit_equal(path, vectors):
    """Every JAX default passed explicitly gives the result of the call with
    no keyword, on the chain path (n=384) and on the strip path (the n=1536
    matrix of ``test_torch_port_eigdc_strip.py``)."""
    H = H384 if path == "chain" else torch.tensor(_spectrum_matrix(_bench512_profile(STRIP_N)))
    bare = eigh_dc(H, eigenvectors=vectors, return_info=True)
    explicit = eigh_dc(H, eigenvectors=vectors, return_info=True, **_jax_defaults())
    assert _same(bare, explicit)


@pytest.mark.parametrize("knob", ["basis_prec", "q_prec", "deskew_prec"])
def test_precision_knob_high_runs_as_highest(knob):
    """``"high"`` (the TPU's bf16_3x) runs in full f32 in the port, so it
    gives the ``"highest"`` result and that of ``None``; any other name
    raises."""
    results = [eigh_dc(H384, eigenvectors=False, return_info=True, **{knob: prec})
               for prec in (None, "highest", "high")]
    assert _same(results[0], results[1]) and _same(results[0], results[2])
    with pytest.raises(ValueError, match=knob):
        eigvalsh_dc(H384, **{knob: "bf16"})
