"""Build and load the port's CUDA kernels and its host C++ library.

Each ``.cu`` source under ``csrc/`` is compiled by ``nvcc`` for ``sm_90a``
into a shared library with a plain C interface, at first use, into
``build/kernels/`` at the root of the checkout, and loaded with ``ctypes``.
The host C++ sources (``csrc/ssim.cpp``, the native SSIM, and
``csrc/patch_sampler.cpp``, the finetuners' patch sampler) are compiled the
same way by ``g++`` into ``build/host/``.
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

__all__ = ["BUILD_DIR", "CSRC_DIR", "HOST_BUILD_DIR", "build", "build_host",
           "load_fused_block", "load_neighbor", "load_patch_sampler", "load_retrieval",
           "load_ssim"]

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "kernels"
HOST_BUILD_DIR = PACKAGE_DIR.parent / "build" / "host"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
GXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-pthread"]


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        "/usr/local/cuda/bin/nvcc",
        shutil.which("nvcc") or "",
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _source(source: str) -> Path:
    src = CSRC_DIR / source
    if not src.is_file():
        raise RuntimeError(
            f"{src} not found: the native libraries build from a checkout of "
            "the repository or an editable install (pip install -e .), not "
            "from an installed wheel")
    return src


def _compile(src: Path, compiler: str, flags: list, salt: bytes,
             out_dir: Path) -> tuple[Path, str]:
    """Compile ``src`` into ``out_dir`` unless an up-to-date library exists.

    The library name carries a hash of the source, ``salt`` (the headers)
    and the flags. It is written under a temporary name and renamed into
    place, so concurrent builds never load a half-written file. Returns
    (path of the .so, the compiler's output: empty when nothing was built).
    """
    digest = hashlib.sha256(
        src.read_bytes() + salt + " ".join(flags).encode()
    ).hexdigest()[:16]
    out = out_dir / f"lib{src.stem}_{digest}.so"
    if out.exists():
        return out, ""
    out_dir.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    try:
        proc = subprocess.run([compiler, *flags, "-o", tmp, str(src)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"{os.path.basename(compiler)} failed on {src} (exit "
                f"{proc.returncode}):\n{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out, proc.stdout + proc.stderr


def build(source: str, defines: tuple = ()) -> tuple[Path, str]:
    """Compile ``csrc/<source>`` with ``nvcc`` unless an up-to-date library
    exists. ``defines`` (``NAME=value`` strings, passed as ``-D``) build a
    variant of the source under its own name. Returns (path of the .so,
    nvcc's output: empty when nothing was built)."""
    src = _source(source)
    # the shared headers (csrc/*.cuh) are part of every source's hash
    headers = b"".join(h.read_bytes() for h in sorted(CSRC_DIR.glob("*.cuh")))
    return _compile(src, _nvcc(), NVCC_FLAGS + [f"-D{d}" for d in defines],
                    headers, BUILD_DIR)


def build_host(source: str) -> tuple[Path, str]:
    """Compile the host C++ ``csrc/<source>`` with ``g++`` unless an
    up-to-date library exists; (path of the .so, g++'s output)."""
    gxx = shutil.which(os.environ.get("CXX", "g++"))
    if gxx is None:
        raise RuntimeError("g++ not found (set CXX or put g++ on PATH)")
    return _compile(_source(source), gxx, GXX_FLAGS, b"", HOST_BUILD_DIR)


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
    """The N2N sub-sampler library (csrc/neighbor.cu), built on first call;
    it also holds the empty kernel that times the launch floor."""
    path, _ = build("neighbor.cu")
    lib = ctypes.CDLL(str(path))
    fn = lib.idt_subsample_pair
    i, p = ctypes.c_int, ctypes.c_void_p
    fn.argtypes = [i, p, i, i, i, i, ctypes.c_uint64, p, p, p, p, p]
    fn.restype = i
    lib.idt_empty_launches.argtypes = [i, p]
    lib.idt_empty_launches.restype = i
    return lib


@functools.lru_cache(maxsize=None)
def load_ssim() -> ctypes.CDLL:
    """The native SSIM (csrc/ssim.cpp, host C++), built on first call.
    ``ssim_gray`` holds no shared state and ctypes releases the GIL while it
    runs, so several threads score frames at once."""
    path, _ = build_host("ssim.cpp")
    lib = ctypes.CDLL(str(path))
    dp = ctypes.POINTER(ctypes.c_double)
    lib.ssim_gray.argtypes = [dp, dp, ctypes.c_int, ctypes.c_int]
    lib.ssim_gray.restype = ctypes.c_double
    return lib


@functools.lru_cache(maxsize=None)
def load_patch_sampler() -> ctypes.CDLL:
    """The native patch sampler (csrc/patch_sampler.cpp, host C++), built on
    first call. A sampler handle holds its frames; ``ps_sample_batch``
    spreads a batch's crops over its own threads."""
    path, _ = build_host("patch_sampler.cpp")
    lib = ctypes.CDLL(str(path))
    i, p, u64 = ctypes.c_int, ctypes.c_void_p, ctypes.c_uint64
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.ps_create.argtypes = [i]
    lib.ps_create.restype = p
    lib.ps_destroy.argtypes = [p]
    lib.ps_destroy.restype = None
    lib.ps_add_image.argtypes = [p, i, u8p, u8p, i, i, i]
    lib.ps_add_image.restype = i
    lib.ps_sample_batch.argtypes = [p, u64, u64, i, i, ctypes.POINTER(ctypes.c_int32),
                                    ctypes.POINTER(ctypes.c_float),
                                    ctypes.POINTER(ctypes.c_float), i]
    lib.ps_sample_batch.restype = i
    return lib
