"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source compiles in its own ``nvcc`` process, all started together,
and one more ``nvcc`` links the objects into a shared library with a
plain C interface, loaded with :mod:`ctypes` (no PyTorch headers, so a
build takes seconds, not minutes).  The library lands in
``build/tao_amodal_torch/`` at the repository root, named by a hash of
the sources and flags, so an edited source never loads a stale build.
Each compile runs ``ptxas -v``; its report (registers, shared memory and
spills of every kernel) is kept beside the library (:func:`ptxas_report`).

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
import re
import shutil
import subprocess
import tempfile

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "tao_amodal_torch")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")
COMPILE_FLAGS = ("-Xptxas", "-v")

P, I, L, F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
              ctypes.c_float)
# C signatures of the entry points in csrc/ (pointers and the stream as
# void*, never as int: ctypes would cut a 64-bit pointer to 32 bits).
SIGNATURES = {
    # frames, ytap, ywt, xtap, xwt, norm, out, T, H, W, Sh, Sw, content
    # extent y_lo, y_hi, x_lo, x_hi, stream
    "tao_preproc_f32": (P,) * 7 + (I,) * 9 + (P,),
    # W, Sw -> shared memory bytes of one block
    "tao_preproc_smem": (I, I),
    # canvas, rois, out, T, Hc, Wc, C, R, out_size, stream
    "tao_prroi_f32": (P, P, P, I, I, I, I, I, I, P),
    # the same for a bf16 canvas, with the form (0 B2, 1 B5, 2 B6)
    # before the stream
    "tao_prroi_bf16": (P, P, P, I, I, I, I, I, I, I, P),
    # x, w, bias, res, out, workspace, T, H, W, Cin, Cout, ksize, relu,
    # tile width, splits, slices per split, stream
    "tao_conv_nhwc_f32": (P,) * 6 + (I,) * 10 + (P,),
    # boxes, valid, 10 state fields in, 10 out, ids, report,
    # T, D, K, max_age, min_hits, iou_threshold, stream
    "tao_sort_scan_f32": (P,) * 24 + (I, I, I, I, I, F, P),
    # D, K -> shared memory bytes of the block, -1 past the kernel's K, D
    "tao_sort_scan_smem": (I, I),
    # out (device int64[3]: cycles and ns of the phases, a sink),
    # phases, stream
    "tao_sort_scan_phase_probe": (P, I, P),
    # x, w1, w2, w3, s1, b1, s2, b2, s3, b3, res_scale, y1, y2, out0,
    # out1, workspace, tile counters, transposed weights, plans (host
    # int[9]), N, T, H, W, C, M, tile counters' count, stream
    "tao_identity_stack_s8": (P,) * 19 + (I,) * 7 + (P,),
    # the same without res_scale and the transposed weights
    "tao_identity_stack_bf16": (P,) * 17 + (I,) * 7 + (P,),
    # B4's bf16 chain (csrc/conv_sm90.cu): x, weights and biases (host
    # void*[4 per block]), a, h, res, out0, out1, workspace, tile
    # counters, plans (host int[12 per block]), blocks, T, H, W, Cin, M,
    # k16-steps a rounding group, stream
    "tao_chain_bf16_sm90": (P,) * 11 + (I,) * 7 + (P,),
    # the int8 trunk conv: x, w, s_w, s_x (or null), out, workspace, tile
    # counters, T, Hi, Wi, Cin, Ho, Wo, Cout, ksize, stride, bf16 output,
    # tile width, splits, slices per split, stream
    "tao_conv_s8_sm90": (P,) * 7 + (I,) * 13 + (P,),
    # the int8 trunk's activation quantization: x, bf16 input, s_x (4
    # f32: s_x and the grid barrier's state), out, T, C, H, W, element
    # strides of (T, C, H, W), Cp, the static scale, dynamic, stream
    "tao_quantize_s8": (P, I, P, P) + (I,) * 4 + (L,) * 4 + (I, F, I, P),
    # NMS from the boxes (csrc/fixpoint.cu): boxes, scores, valid (or
    # null), keep, the packed suppression words, B, n, threshold, stream
    "tao_nms_keep": (P, P, P, P, P, I, I, F, P),
    # NMS's fixpoint of a given bool sup: sup, valid, keep, the words, B,
    # n, stream
    "tao_nms_fixpoint": (P, P, P, P, I, I, P),
    # the greedy assignment's fixpoint: b, row_to_col, rounds run (int32
    # or null), n, m, stream
    "tao_greedy_fixpoint": (P, P, P, I, I, P),
    # n, m, b in shared memory -> bytes of the block, -1 past it
    "tao_greedy_fixpoint_smem": (I, I, I),
    # bf16 input -> bytes the flat quantizer keeps on chip over the device
    "tao_quantize_s8_kept_bytes": (I,),
    # the auction's rounds (csrc/auction.cu): shifted b, row_to_col,
    # rounds run (int32 or null), n, m, eps, floor, max_iters, stream
    "tao_auction_rounds": (P, P, P, I, I, F, F, I, P),
    # n, m -> shared memory bytes of the block, -1 past it
    "tao_auction_rounds_smem": (I, I),
}


# Entry points that return something else than a CUDA error code.
RESTYPES = {"tao_preproc_smem": ctypes.c_longlong,
            "tao_sort_scan_smem": ctypes.c_longlong,
            "tao_greedy_fixpoint_smem": ctypes.c_longlong,
            "tao_auction_rounds_smem": ctypes.c_longlong,
            "tao_quantize_s8_kept_bytes": ctypes.c_longlong}


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
    h = hashlib.sha256(" ".join(NVCC_FLAGS + COMPILE_FLAGS).encode())
    for src in _sources():
        with open(src, "rb") as f:
            h.update(os.path.basename(src).encode() + f.read())
    return os.path.join(BUILD_DIR, f"libtao_kernels_{h.hexdigest()[:16]}.so")


def _run(procs):
    """Wait for every ``(cmd, Popen)``; raise on the first failure, else
    return their output (ptxas reports on either stream)."""
    errors, logs = [], []
    for cmd, proc in procs:
        out, err = proc.communicate()
        logs.append(out + err)
        if proc.returncode != 0:
            errors.append(f"nvcc failed ({proc.returncode}):\n"
                          f"{' '.join(cmd)}\n{err}")
    if errors:
        raise RuntimeError("\n".join(errors))
    return logs


def build():
    """Compile ``csrc/*.cu`` unless the library for these sources exists.

    Returns the library path.  Objects and the library are written under
    a temporary directory and the library is renamed into place, so
    concurrent builds never load a half-written file.
    """
    path = library_path()
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for src in _sources():
            if not src.endswith(".cu"):
                continue
            obj = os.path.join(tmp, os.path.basename(src) + ".o")
            cmd = [nvcc, *NVCC_FLAGS, *COMPILE_FLAGS, "-c", "-o", obj, src]
            procs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
            objs.append(obj)
        report = "".join(_run(procs))
        lib = os.path.join(tmp, "lib.so")
        cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", lib, *objs]
        _run([(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.PIPE, text=True))])
        with open(path + ".ptxas.txt", "w") as f:
            f.write(report)
        os.replace(lib, path)
    return path


def ptxas_report():
    """:func:`parse_ptxas` of the built library's report."""
    with open(build() + ".ptxas.txt") as f:
        return parse_ptxas(f.read())


def parse_ptxas(text):
    """``{kernel: {"registers", "smem", "spill_stores", "spill_loads"}}``
    from ``ptxas -v`` output (mangled names; ``smem`` is static shared
    memory, dynamic shared memory is set at launch)."""
    kernels, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            kernels[name] = dict(registers=0, smem=0, spill_stores=0,
                                 spill_loads=0)
            continue
        if name is None:
            continue
        k = kernels[name]
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            k["spill_stores"], k["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            k["registers"] = int(m.group(1))
        m = re.search(r"(\d+) bytes smem", line)
        if m:
            k["smem"] = int(m.group(1))
    return kernels


@functools.cache
def library():
    """The loaded kernel library, built on first use."""
    lib = ctypes.CDLL(build())
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = RESTYPES.get(name, ctypes.c_int)
    return lib


def check(name, err):
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
