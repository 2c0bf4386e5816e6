"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

All sources compile in one ``nvcc`` call into a shared library with a
plain C interface, loaded with :mod:`ctypes` (no PyTorch headers, so a
build takes seconds, not minutes).  The library lands in
``build/tao_amodal_torch/`` at the repository root, named by a hash of
the sources and flags, so an edited source never loads a stale build.

Every C entry point takes device pointers and the CUDA stream as
``void*`` and returns ``cudaGetLastError()``; :func:`check` raises when
that is not 0 (a refused launch never runs, and a later synchronize
would not report it).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "tao_amodal_torch")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

P, I = ctypes.c_void_p, ctypes.c_int
# C signatures of the entry points in csrc/ (pointers and the stream as
# void*, never as int: ctypes would cut a 64-bit pointer to 32 bits).
SIGNATURES = {
    # frames, ytap, ywt, xtap, xwt, norm, out, T, H, W, Sh, Sw, stream
    "tao_preproc_f32": (P, P, P, P, P, P, P, I, I, I, I, I, P),
    # canvas, rois, out, T, Hc, Wc, C, R, out_size, stream
    "tao_prroi_f32": (P, P, P, I, I, I, I, I, I, P),
}


def _sources():
    return sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC)
                  if f.endswith((".cu", ".cuh")))


def _nvcc():
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.path.join(cuda_home, "bin", "nvcc"),
                 shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                       "of tao_amodal_torch build only where the CUDA "
                       "toolkit is installed")


def library_path():
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        with open(src, "rb") as f:
            h.update(os.path.basename(src).encode() + f.read())
    return os.path.join(BUILD_DIR, f"libtao_kernels_{h.hexdigest()[:16]}.so")


def build():
    """Compile ``csrc/*.cu`` unless the library for these sources exists.

    Returns the library path.  The compile writes to a temporary name
    and renames, so concurrent builders never load a half-written file.
    """
    path = library_path()
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
           *[s for s in _sources() if s.endswith(".cu")]]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stderr}")
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return path


@functools.cache
def library():
    """The loaded kernel library, built on first use."""
    lib = ctypes.CDLL(build())
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib


def check(name, err):
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
