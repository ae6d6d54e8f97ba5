"""The numbers that decide ``correct``: each answer of the program against
the reference's answer for the same batch.  Every number is a gap, 0 for
an exact answer; ``PERF.md`` gives the readings each limit was set from."""

import torch


def spectrum(out, ref, n):
    """A spectrum (ascending) against the reference's, relative gaps
    ``|l_i - r_i| / r_i``:

    * ``top_gap``: the widest over the eigenvalues of at least a hundredth
      of the largest;
    * ``bulk_gap``: the median over those of at least a thousandth of the
      largest (the bulk of the spectrum, where a lower precision moves
      every eigenvalue and a rounding error a few);
    * ``abs_gap``: the widest ``|l_i - r_i|`` over the whole spectrum,
      against the largest eigenvalue ``r_max``: any eigenvalue that is off,
      the largest or a small one lost, at the scale of the spectrum;
    * ``zeros_off``: how far the count of exact zeros is from the ``n``
      structural zeros of the deflated cross-entropy GGN."""
    out = out.detach().double().cpu()
    ref = ref.detach().double().cpu()
    if out.shape != ref.shape:
        return {k: float("inf") for k in ("top_gap", "bulk_gap", "abs_gap", "zeros_off")}
    rel = (out - ref).abs() / ref.abs().clamp(min=torch.finfo(torch.float64).tiny)
    largest = ref.abs().max()
    return {"top_gap": rel[ref >= 1e-2 * largest].max().item(),
            "bulk_gap": rel[ref >= 1e-3 * largest].median().item(),
            "abs_gap": ((out - ref).abs().max() / largest).item(),
            "zeros_off": float(abs(int((out == 0).sum()) - n))}

