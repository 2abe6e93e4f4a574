"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface (no PyTorch headers), so it
compiles with ``nvcc`` in seconds into its own shared library, loaded with
``ctypes``.  All sources compile in parallel, one ``nvcc`` process each, on
first use; the libraries land in ``build/torch_kernels/`` at the repository
root, named by a hash of their sources and flags, so a rebuild happens only
when a source changes.  Nothing here runs when the module is imported.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
SOURCES = ("rmsnorm", "flash_attention", "flash_decode", "rglru")
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo")

# dtype codes of csrc/common.cuh
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

# Every exported C function's argument types (each returns a cudaError_t as
# an int), set once when its library loads.
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
SIGNATURES = {
    "rmsnorm": {
        "repro_rmsnorm": [_P, _P, _P, ctypes.c_longlong, _I, _F] + [_I] * 5
        + [_P],
        "repro_rmsnorm_attrs": [_I] * 5 + [_P],
    },
    "flash_attention": {
        "repro_flash_attention": [_P] * 4 + [_I] * 6 + [_F] + [_I] * 4 + [_P],
        "repro_flash_attention_attrs": [_I, _I, _P],
    },
    "flash_decode": {
        "repro_flash_decode": [_P] * 7 + [_I] * 7 + [_F] + [_I] * 5 + [_P],
        "repro_flash_decode_attrs": [_I, _I, _P],
    },
    "rglru": {
        "repro_rglru": [_P] * 4 + [_I] * 7 + [_P],
        "repro_rglru_bwd": [_P] * 7 + [_I] * 6 + [_P],
        "repro_rglru_smem": [_I] * 4 + [_P],
        "repro_rglru_attrs": [_P],
    },
}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of the CUDA compiler: ``$CUDA_HOME/bin/nvcc`` (``CUDA_HOME``
    defaults to ``/usr/local/cuda``), else ``nvcc`` on ``PATH``."""
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the port's CUDA kernels are "
            "built from source on the machine with the card")
    return found


def _library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu``'s library lives: named by a hash of the
    source, every header of ``csrc/`` and the flags."""
    h = hashlib.sha256()
    for f in (CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all() -> dict[str, float]:
    """Compile every missing library, all ``nvcc`` runs at once, and load
    them.  Returns the wall seconds of the build (0.0 when all were
    present).  Raises with the compiler's output if one fails."""
    with _lock:
        if len(_libs) == len(SOURCES):
            return {"seconds": 0.0}
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        procs = {}
        for name in SOURCES:
            out = _library_path(name)
            if out.is_file():
                continue
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            procs[name] = (out, tmp, subprocess.Popen(
                [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        errors = []
        for name, (out, tmp, proc) in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"nvcc {name}.cu failed:\n{log}")
            else:
                os.replace(tmp, out)
        if errors:
            raise RuntimeError("\n".join(errors))
        for name in SOURCES:
            lib = ctypes.CDLL(str(_library_path(name)))
            lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
            lib.repro_cuda_error_string.restype = ctypes.c_char_p
            for fn, argtypes in SIGNATURES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _libs[name] = lib
        return {"seconds": time.perf_counter() - t0}


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (built on first use)."""
    if name not in _libs:
        build_all()
    return _libs[name]


def check(name: str, err: int) -> None:
    """Raise if a launch returned a CUDA error (a refused launch never
    runs, and a later synchronise would not report it)."""
    if err != 0:
        msg = library(name).repro_cuda_error_string(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} ({err})")


@functools.cache
def sm_count(device_index: int) -> int:
    """Streaming multiprocessors of a CUDA device (read once per device)."""
    return torch.cuda.get_device_properties(
        device_index).multi_processor_count


def stream_of(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())
