"""The plain reference against float64 by other means on a tiny network,
and against the program on the CPU."""

import pytest
import torch

import harness
import judge
import tiny
from reference import ggn


@pytest.fixture(scope="module")
def tiny_cell(tmp_path_factory):
    root = tiny.make_tree(str(tmp_path_factory.mktemp("bench")))
    import json
    import os

    with open(os.path.join(os.path.dirname(root), "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    return {name: harness.Cell(name, bench, root) for name in ("tiny_spectrum",)}


@pytest.fixture(scope="module")
def batch(tiny_cell):
    cell = tiny_cell["tiny_spectrum"]
    model, batches = harness.make_inputs(cell, 7, torch.device("cpu"))
    return (cell, model, *batches(0))


def explicit_ggn(model, X, y):
    """``(1/N) sum_n J_n^T (diag p - p p^T) J_n`` in float64, each ``J_n``
    row by its own backward pass."""
    params = [p.detach().double().requires_grad_() for p in model.parameters()]
    names = [n for n, _ in model.named_parameters()]
    n = X.shape[0]
    g = 0
    for i in range(n):
        f = torch.func.functional_call(model, dict(zip(names, params)), (X[i:i + 1].double(),))[0]
        rows = [torch.cat([t.flatten() for t in torch.autograd.grad(f[c], params,
                                                                    retain_graph=True)])
                for c in range(f.shape[0])]
        J = torch.stack(rows)
        p = torch.softmax(f.detach(), dim=-1)
        g = g + J.T @ (torch.diag(p) - torch.outer(p, p)) @ J / n
    return g


def test_factors_are_a_square_root_and_deflate(batch):
    _, model, X, y = batch
    f = model(X).double()
    s = ggn.loss_factors(f, deflate=False)
    d = ggn.loss_factors(f, deflate=True)
    p = torch.softmax(f, dim=-1)
    h = (torch.diag_embed(p) - p[:, :, None] * p[:, None, :]) / X.shape[0]
    assert torch.allclose(s.transpose(1, 2) @ s, h, atol=1e-14)
    assert torch.allclose(d.transpose(1, 2) @ d, h, atol=1e-14)
    assert d.shape[1] == f.shape[1] - 1
    # the rows of each sample's root combine to zero along sqrt(p): the
    # direction the deflation drops
    assert (p.sqrt()[:, None, :] @ s).abs().max() < 1e-15


def test_spectrum_against_the_explicit_ggn(batch):
    _, model, X, y = batch
    ev = ggn.spectrum(model, X, y, low=torch.float32, dtype=torch.float64)
    want = torch.linalg.eigvalsh(explicit_ggn(model, X, y))
    k = X.shape[0] * 2  # (C - 1) N nonzero eigenvalues
    assert (ev[:X.shape[0]] == 0).all()
    # the low blocks sum in float32 here: absolute errors of ~1e-7 of the largest
    assert torch.allclose(ev[-k:], want[-k:], rtol=1e-5, atol=1e-6 * want[-1])
    assert want[:-k].abs().max() < 1e-10 * want[-1]


def test_low_blocks_are_rounded(batch):
    _, model, X, y = batch
    exact = ggn.spectrum(model, X, y, low=torch.float32)
    low = ggn.spectrum(model, X, y, low=torch.bfloat16)
    gaps = judge.spectrum(low, exact, X.shape[0])
    assert 1e-5 < gaps["top_gap"] < 1e-1


def test_program_agrees_on_the_cpu(batch):
    import vivit_tpu_torch as vtt

    cell, model, X, y = batch
    out = vtt.eigvalsh_structured(model, vtt.CrossEntropyLoss("mean"), X, y, device="cpu",
                                  **cell.config["settings"])[0]
    ref = ggn.spectrum(model, X, y, low=torch.bfloat16)
    gaps = judge.spectrum(out, ref, X.shape[0])
    assert gaps["top_gap"] < 1e-4 and gaps["bulk_gap"] < 1e-4 and gaps["zeros_off"] == 0

