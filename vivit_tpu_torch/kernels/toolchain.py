"""The hand-written kernels' toolchain: each ``csrc/<name>.cu`` is built with
``nvcc`` for ``sm_90a`` into ``vivit_tpu_torch/_build/`` at its kernel's first
CUDA call and opened with ``ctypes``.

:func:`build` compiles a source once per version of its bytes and the flags
(the library's file name holds their digest, so a checkout whose build
directory already has it builds nothing); :func:`load` opens the library once
per process, declares the C entries it is handed and runs the source's
``vivit_<name>_prepare`` entry once per device where it has one.
"""

import ctypes
import hashlib
import os
import subprocess
import time

import torch

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_BUILD_DIR = os.path.join(_PKG_DIR, "_build")
_NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    # no multiply-add contraction: the kernel rounds every product and sum
    # as its plain version does
    "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
_LIBS = {}  # name -> the opened library
_PREPARED = set()  # (name, device) whose prepare entry has run


def build(name: str):
    """Compile ``csrc/<name>.cu`` for ``sm_90a``, once per version of the
    source and flags, and return ``(library path, seconds, compiler
    output)``."""
    source = os.path.join(_PKG_DIR, "csrc", f"{name}.cu")
    with open(source, "rb") as fh:
        digest = hashlib.sha256(fh.read() + " ".join(_NVCC_FLAGS).encode())
    lib_path = os.path.join(_BUILD_DIR, f"lib{name}_{digest.hexdigest()[:12]}.so")
    if os.path.exists(lib_path):
        return lib_path, 0.0, ""
    os.makedirs(_BUILD_DIR, exist_ok=True)
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    nvcc = os.path.join(cuda_home, "bin", "nvcc")
    tmp = f"{lib_path}.{os.getpid()}.tmp"
    cmd = [nvcc, *_NVCC_FLAGS, "-o", tmp, source]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, lib_path)
    return lib_path, seconds, proc.stderr


def load(name: str, entries, device, kernel: str):
    """The library of ``csrc/<name>.cu`` (``kernel`` in errors) for a launch
    on ``device``, built (:func:`build`) and opened once per process, each of
    ``entries`` (``{symbol: argtypes}``) declared to return a C ``int``.

    Where ``entries`` hold ``vivit_<name>_prepare`` (the kernel raises its
    device's shared-memory limit), it runs once per device, at the first
    launch there: the limit belongs to the device's context, and an eager
    warm-up precedes every capture."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(build(name)[0])
        for symbol, argtypes in entries.items():
            fn = getattr(lib, symbol)
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
        _LIBS[name] = lib
    prepare = f"vivit_{name}_prepare"
    if prepare in entries and (name, device) not in _PREPARED:
        with torch.cuda.device(device):
            err = getattr(lib, prepare)()
        if err != 0:
            raise RuntimeError(f"{kernel}: shared memory limit refused: cudaError {err}")
        _PREPARED.add((name, device))
    return lib
