"""Build and load the CUDA kernels (``csrc/*.cu``) as one shared library.

Each source is compiled by its own ``nvcc`` process, all started
together, for ``sm_90a`` (H100); the objects are linked into
``build/repro_torch/libkernels.so`` at the repository root and loaded
with ``ctypes``.  The library exposes a plain C interface: every pointer
and the CUDA stream are passed as ``c_void_p``, sizes as ``c_int``, an
epsilon as ``c_float``, and each entry returns ``cudaGetLastError()``
after its launches.

The build happens at first use and is skipped while a stamp of the
sources and flags matches, so a process pays it once.  Nothing here runs
at import time: the CPU tests import every module of the package.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import List, Tuple

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
LIB_NAME = "libkernels.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
#: C signatures: name -> argument types (restype is c_int for all)
SIGNATURES = {
    # x_q, w_q, x_scale, w_scale, bias, y, M, N, K, splits, out_bf16, stream
    "mp_matmul": [_P] * 6 + [_I] * 5 + [_P],
    # q, k_pages, v_pages, lengths, block_table, out, scratch, q_bf16,
    # B, H, Hkv, ps, D, n_pg, window, hg, pps, splits, stream
    "paged_mha_decode": [_P] * 7 + [_I] * 11 + [_P],
    # q, k_pages, v_pages, base, block_table, out, scratch, q_bf16,
    # B, C, H, Hkv, ps, D, n_pg, window, nq, pps, splits, stream
    "paged_verify": [_P] * 7 + [_I] * 12 + [_P],
    # q, k_pages, v_pages, base, block_table, anc, out, scratch, q_bf16,
    # B, C, H, Hkv, ps, D, n_pg, nq, pps, splits, stream
    "paged_verify_tree": [_P] * 8 + [_I] * 11 + [_P],
    # q, k_cache, v_cache, lengths, out, scratch, q_bf16, kv_bf16,
    # B, H, Hkv, S, D, window, hg, kps, splits, stream
    "mha_decode": [_P] * 6 + [_I] * 11 + [_P],
    # x, res, w, b, y, rn, yq, scale, x_bf16, res_bf16, B, D, rms, eps,
    # nv, vec, stream
    "ln_res": [_P] * 8 + [_I] * 5 + [_F] + [_I] * 2 + [_P],
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "CUDA kernels build only on a machine with the CUDA toolkit")


def sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def _stamp() -> str:
    """Hash of the code-generating flags and every source (``-Xptxas -v``
    only reports, so a verbose build satisfies a plain one)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()


def build(*, verbose: bool = False) -> Tuple[Path, float, str]:
    """Compile every ``csrc/*.cu`` in parallel and link the library.

    Returns ``(path, seconds, log)``; ``log`` holds the compilers'
    output (with ``verbose``, ``-Xptxas -v``'s register and shared-memory
    report per kernel).  Raises ``RuntimeError`` if a compile fails."""
    extra = ["-Xptxas", "-v"] if verbose else []
    lib = BUILD_DIR / LIB_NAME
    stamp_file = BUILD_DIR / "libkernels.sha256"
    stamp = _stamp()
    if lib.exists() and stamp_file.exists() \
            and stamp_file.read_text() == stamp:
        return lib, 0.0, "up to date"
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in sources():
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, *extra, "-c", str(src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        log = []
        failed = []
        for src, _, proc in procs:
            out, _ = proc.communicate()
            log.append(f"== {src.name}\n{out}")
            if proc.returncode != 0:
                failed.append(src.name)
        if failed:
            raise RuntimeError(
                f"nvcc failed on {failed}:\n" + "\n".join(log))
        tmp_lib = Path(tmp) / LIB_NAME
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(tmp_lib)]
            + [str(obj) for _, obj, _ in procs],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp_lib, lib)
    stamp_file.write_text(stamp)
    return lib, time.perf_counter() - t0, "\n".join(log)


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library (built first if needed), with every
    entry's ``argtypes``/``restype`` declared."""
    path, _, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
