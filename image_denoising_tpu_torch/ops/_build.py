"""Build and load the port's CUDA kernels.

Each source under ``csrc/`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, at first use, into
``build/kernels/`` at the root of the checkout, and loaded with ``ctypes``.
The library name carries a hash of the source and the flags, so an edited
source is rebuilt and a stale library is never loaded. Nothing is compiled
or imported when this module is imported.

The card path runs from a checkout of the repository or an editable install
(``pip install -e .``) only: a wheel ships no ``csrc/`` sources, and the
libraries are written into the checkout's ``build/kernels/``.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

__all__ = ["BUILD_DIR", "CSRC_DIR", "build", "load_fused_block", "load_neighbor",
           "load_retrieval"]

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "kernels"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        "/usr/local/cuda/bin/nvcc",
        shutil.which("nvcc") or "",
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def build(source: str, defines: tuple = ()) -> tuple[Path, str]:
    """Compile ``csrc/<source>`` unless an up-to-date library exists.

    ``defines`` (``NAME=value`` strings, passed as ``-D``) build a variant
    of the source under its own name. Returns (path of the .so, nvcc's output — empty when nothing was built).
    The library is written under a temporary name and renamed into place, so
    concurrent builds never load a half-written file.
    """
    src = CSRC_DIR / source
    if not src.is_file():
        raise RuntimeError(
            f"{src} not found: the CUDA kernels build from a checkout of the "
            "repository or an editable install (pip install -e .), not from "
            "an installed wheel")
    # the shared headers (csrc/*.cuh) are part of every source's hash
    headers = b"".join(h.read_bytes() for h in sorted(CSRC_DIR.glob("*.cuh")))
    flags = NVCC_FLAGS + [f"-D{d}" for d in defines]
    digest = hashlib.sha256(
        src.read_bytes() + headers + " ".join(flags).encode()
    ).hexdigest()[:16]
    out = BUILD_DIR / f"lib{src.stem}_{digest}.so"
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [_nvcc(), *flags, "-o", tmp, str(src)],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed on {src} (exit {proc.returncode}):\n"
                f"{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out, proc.stdout + proc.stderr


@functools.lru_cache(maxsize=None)
def load_fused_block(defines: tuple = ()) -> ctypes.CDLL:
    """The chain-conv library (csrc/fused_block.cu), built on first call;
    ``defines`` select a variant (``build``), as scripts/probe_chain.py does."""
    path, _ = build("fused_block.cu", defines)
    lib = ctypes.CDLL(str(path))
    fn = lib.idt_chain_conv
    i, p = ctypes.c_int, ctypes.c_void_p
    fn.argtypes = [i, i, i, p, i, i, p, p, p, p, i, p, i, i, i, i, i, p, i, i, i, p]
    fn.restype = i
    return lib


@functools.lru_cache(maxsize=None)
def load_retrieval() -> ctypes.CDLL:
    """The top-1 retrieval library (csrc/retrieval.cu), built on first call."""
    path, _ = build("retrieval.cu")
    lib = ctypes.CDLL(str(path))
    fn = lib.idt_top1_l2
    i, p = ctypes.c_int, ctypes.c_void_p
    fn.argtypes = [i, p, p, p, i, i, i, p, p, p]
    fn.restype = i
    return lib


@functools.lru_cache(maxsize=None)
def load_neighbor() -> ctypes.CDLL:
    """The N2N sub-sampler library (csrc/neighbor.cu), built on first call."""
    path, _ = build("neighbor.cu")
    lib = ctypes.CDLL(str(path))
    fn = lib.idt_subsample_pair
    i, p = ctypes.c_int, ctypes.c_void_p
    fn.argtypes = [i, p, i, i, i, i, ctypes.c_uint64, p, p, p, p, p]
    fn.restype = i
    return lib
