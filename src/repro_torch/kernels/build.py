"""Builds the CUDA kernels at first use and loads them with ctypes.

Each ``csrc/<name>.cu`` compiles on its own (``nvcc -gencode
arch=compute_90a,code=sm_90a``) into ``build/kernels/lib<name>-<hash>.so``
at the repository root; the hash covers the source and the shared headers,
so an edited source builds anew. The libraries have a plain C interface:
pointers and the stream are ``c_void_p``, sizes ``c_int``, and every entry
point returns ``cudaGetLastError()`` after its launch. Strides go as a
host array of ``long long``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_STRIDES = ctypes.POINTER(ctypes.c_longlong)
# C signature of every entry point: name -> (library, argtypes)
SIGNATURES = {
    "block_matmul": ("block_matmul", [_P, _P, _P, _I, _I, _I, _I, _I, _P]),
    "fused_dense": ("fused_dense", [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P]),
    "forest_predict": ("decision_forest", [_P] * 5 + [_I] * 12 + [_P]),
    "flash_attention": ("flash_attention", [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                            _I, _I, _I, _I, _F, _STRIDES, _P]),
    "flash_attention_bwd": ("flash_attention_bwd", [_P] * 10 + [_I] * 9
                            + [_F, _STRIDES, _P]),
    "flash_decode": ("flash_decode", [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                      _I, _I, _I, _I, _I, _I, _I, _I, _F,
                                      _STRIDES, _P]),
    "flash_decode_chunk": ("flash_decode", [_I, _I]),
}
LIBRARIES = ("block_matmul", "decision_forest", "fused_dense", "flash_attention",
             "flash_attention_bwd", "flash_decode")

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}  # library -> loaded shared object
_entries: Dict[str, object] = {}  # entry point -> configured ctypes function
build_log: Dict[str, str] = {}  # library -> nvcc's output (registers, spills)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                       "the CUDA toolkit is installed")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for src in [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh")):
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names: Sequence[str] = LIBRARIES) -> float:
    """Compile the named libraries that are not built yet, one ``nvcc`` per
    source, all started together. Returns the wall seconds taken."""
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        build_log[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def entry(fn: str):
    """The ctypes function ``fn``, building and loading its library at
    first use."""
    f = _entries.get(fn)
    if f is not None:
        return f
    lib_name, argtypes = SIGNATURES[fn]
    with _lock:
        lib = _loaded.get(lib_name)
        if lib is None:
            build([lib_name])
            lib = ctypes.CDLL(str(_lib_path(lib_name)))
            _loaded[lib_name] = lib
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
        _entries[fn] = f
    return f
