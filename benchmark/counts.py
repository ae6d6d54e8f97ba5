"""Operations and bytes of the benchmark's rooflines and of a query's share
of the card's peak, from shapes alone, and the table of peaks.

Nothing here reads the program: the counts follow from a configuration's
layers (its network file's ``layers``) and from the batches a kernel is
handed.  ``PERF.md`` derives each count.
"""

import math

# NVIDIA H100 SXM (H100 80GB HBM3), data sheet, dense, at the 700 W limit
PEAKS = {
    "float32": 67e12,  # FLOP/s outside the tensor cores
    "tf32": 495e12,
    "bfloat16": 989e12,
    "hbm_bytes": 3.35e12,  # bytes/s
}


def layer_macs(layer):
    """Multiply-adds of one sample through the layer's forward."""
    if layer["kind"] == "dense":
        return layer["in"] * layer["out"]
    oh, ow = layer["out_hw"]
    return oh * ow * layer["out"] * layer["in"] * layer["kernel"] ** 2


def layer_params(layer):
    """Weights and bias of the layer."""
    if layer["kind"] == "dense":
        return layer["in"] * layer["out"] + layer["out"]
    return layer["out"] * layer["in"] * layer["kernel"] ** 2 + layer["out"]


def parameters(layers):
    return sum(layer_params(layer) for layer in layers)


def forward_macs(layers):
    """Multiply-adds of one sample's forward."""
    return sum(layer_macs(layer) for layer in layers)


def eigh_flops(n, vectors):
    """An ``n x n`` symmetric eigendecomposition: the tridiagonal reduction
    ``(4/3) n^3``, plus ``2 n^2 k`` to back-transform ``k`` vectors."""
    return 4 / 3 * n ** 3 + 2 * n ** 2 * vectors


def query_parts(layers, n, c, k=0):
    """``{part: (flops, precision)}`` of one spectrum query on a batch
    of ``n`` samples and ``c`` classes, for the undeflated ``n*c`` factor
    columns:

    * ``forward``: ``2 n M`` with ``M`` the forward's multiply-adds;
    * ``backward``: one per factor column, the data-gradient chain through
      every layer above the first (``2 n c (M - M_first)``) and the
      parameter contraction of the convolutions' patches with their output
      cotangents (``2 n c M_conv``);
    * ``gram_conv``: the convolution weights' and all biases' blocks,
      ``2 (nc)^2 D_conv`` in bf16;
    * ``gram_dense``: the dense weights' blocks in the ``(ZZ^T)o(DD^T)``
      form, ``2 n^2 in + 2 (nc)^2 out + (nc)^2`` each, in f32;
    * ``eigensolve``: :func:`eigh_flops` of ``nc`` with ``k`` vectors.
    """
    nc = n * c
    macs = forward_macs(layers)
    first = layer_macs(layers[0])
    convs = [layer for layer in layers if layer["kind"] == "conv"]
    denses = [layer for layer in layers if layer["kind"] == "dense"]
    conv_macs = sum(layer_macs(layer) for layer in convs)
    d_low = (sum(layer_params(layer) for layer in convs)
             + sum(layer["out"] for layer in denses))
    parts = {
        "forward": (2 * n * macs, "float32"),
        "backward": (2 * n * c * (macs - first) + 2 * n * c * conv_macs, "float32"),
        "gram_conv": (2 * nc ** 2 * d_low, "bfloat16"),
        "gram_dense": (sum(2 * n ** 2 * d["in"] + 2 * nc ** 2 * d["out"] + nc ** 2
                           for d in denses), "float32"),
        "eigensolve": (eigh_flops(nc, k), "float32"),
    }
    return parts


def least_seconds(parts, chips=1):
    """The least time of the parts at the peaks of their precisions, the
    work spread over ``chips`` cards."""
    return sum(flops / PEAKS[prec] for flops, prec in parts.values()) / chips


def eigh_batch_flops(b, m):
    """A kernel's batch ``[b, m, m]``: ``b`` eigendecompositions with all
    ``m`` vectors, ``(4/3) m^3 + 2 m^3`` each."""
    return b * eigh_flops(m, m)


def eigh_batch_bytes(b, m):
    """Each input read once, each output written once: ``A`` in, the
    eigenvalues, eigenvectors and the sweep counts out, 4 bytes each."""
    return 4 * (b * m * m + b * m + b * m * m + b)


def roofline_seconds(batches):
    """The least time of a list of ``(b, m)`` kernel batches: the larger of
    their operations at the f32 peak and their bytes at the memory peak."""
    flops = sum(eigh_batch_flops(b, m) for b, m in batches)
    moved = sum(eigh_batch_bytes(b, m) for b, m in batches)
    return max(flops / PEAKS["float32"], moved / PEAKS["hbm_bytes"])


def quantile(values, q):
    """The ``q`` quantile (0 < q < 1) by linear interpolation between order
    statistics (``statistics.quantiles``' inclusive method)."""
    xs = sorted(values)
    if len(xs) == 1:
        return xs[0]
    pos = q * (len(xs) - 1)
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)
