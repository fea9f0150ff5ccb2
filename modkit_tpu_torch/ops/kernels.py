"""Build and load the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` is compiled on first use by ``nvcc`` for ``sm_90a``
into its own shared library with a plain C interface (``_build/``, see
``sobuild``) and loaded with ``ctypes``. Nothing here runs at import: the
machine that runs the CPU tests has no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor

from ..sobuild import build_once

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-fmad=false", "-std=c++17",
    "-shared", "-Xcompiler", "-fPIC",
)

# C entry points of each library: name -> argtypes (pointers and the
# stream as c_void_p; every entry returns a cudaError_t as int)
_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I32 = ctypes.c_int32
_SIGNATURES = {
    "state": {
        "mk_state_quals_t": [_P, _P, _P, _P, _I64, _I32, _P, _P, _P, _P],
        "mk_state_f32": [_P, _P, _I64, _I32, _P, _P, _P, _P],
    },
    "counts": {
        "mk_modcall_counts": [_P, _P, _P, _P, _I64, _I32, _I64, _P, _P, _P, _P],
    },
    "lab_counts": {
        "mk_lab_hist": [_I32, _P, _P, _P, _P, _I64, _I32, _I32, _P, _P],
        "mk_lab_group": [_P, _P, _I32, _I64, _P, _P],
        "mk_lab_diag": [_I32, _P, _P, _P, _P, _I64, _I32, _I32, _P, _P],
    },
}

_libs: dict = {}
_lock = threading.Lock()


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH,
    else the toolkit's default location."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in (
        os.path.join(home, "bin", "nvcc") if home else None,
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found: set CUDA_HOME to the CUDA toolkit to build the "
        "modkit_tpu_torch kernels"
    )


def _sources(name: str, csrc: str) -> list[str]:
    return [os.path.join(csrc, f"{name}.cu"), os.path.join(csrc, "call.cuh")]


def _compile(name: str, csrc: str, so_path: str) -> None:
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", so_path, _sources(name, csrc)[0]]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed to build csrc/{name}.cu:\n{proc.stderr}"
        )


def library_path(name: str, csrc: str = CSRC) -> str:
    """Build (once) and return the shared library of ``<csrc>/<name>.cu``."""
    return build_once(
        f"lib{name}", _sources(name, csrc), NVCC_FLAGS,
        lambda tmp: _compile(name, csrc, tmp),
    )


def open_library(name: str, csrc: str = CSRC) -> ctypes.CDLL:
    """Build (once) and load ``<csrc>/<name>.cu`` with its argtypes set."""
    lib = ctypes.CDLL(library_path(name, csrc))
    for fn, argtypes in _SIGNATURES[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    lib.mk_cuda_error_string.argtypes = [ctypes.c_int]
    lib.mk_cuda_error_string.restype = ctypes.c_char_p
    return lib


def kernel_lib(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, the one the wrappers launch."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = _libs[name] = open_library(name)
    return lib


def build_kernels() -> list[str]:
    """Build every kernel library at once, one ``nvcc`` per source."""
    with ThreadPoolExecutor(max_workers=len(_SIGNATURES)) as pool:
        return list(pool.map(library_path, _SIGNATURES))


def check_aligned(what: str, named: dict, align: int = 16) -> None:
    """Raise unless every tensor's base pointer is ``align``-byte aligned,
    as the kernels' wide loads need."""
    for name, t in named.items():
        if t.data_ptr() % align:
            raise ValueError(f"{what}: {name} is not {align}-byte aligned "
                             f"(base pointer {t.data_ptr():#x})")


def check_launch(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a kernel entry point returned a CUDA error."""
    if rc != 0:
        msg = lib.mk_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {rc} ({msg})")
