"""Nothing the benchmark runs imports ``jax``, ``jaxlib``, ``flax`` or the
JAX package ``vivit_tpu`` (top-level names compared whole:
``vivit_tpu_torch`` is the port), and the reference imports nothing of the
program."""

import ast
import os
import subprocess
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "vivit_tpu"}


def imported(path):
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def sources(top):
    for root, _, files in os.walk(top):
        yield from (os.path.join(root, f) for f in files if f.endswith(".py"))


def test_no_jax_anywhere():
    found = [(p, m) for p in sources(BENCH) for m in imported(p)
             if m.split(".")[0] in FORBIDDEN]
    assert not found, found


def test_reference_imports_nothing_of_the_program():
    allowed = {"torch", "contextlib", "math"}
    found = [(p, m) for p in sources(os.path.join(BENCH, "reference")) for m in imported(p)
             if m.split(".")[0] not in allowed]
    assert not found, found


def test_loaded_modules_hold_no_jax():
    code = ("import sys\n"
            f"sys.path[:0] = [{BENCH!r}, {os.path.dirname(BENCH)!r}]\n"
            "import harness, counts, timeline, judge, program\n"
            "import vivit_tpu_torch, vivit_tpu_torch.parallel\n"
            "from reference import ggn\n"
            "print(harness.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, check=True).stdout.strip()
    assert out == "[]"
