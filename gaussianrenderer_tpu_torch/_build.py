"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` exports a plain C interface and is compiled on
first use into its own shared library under ``build/torch_kernels/`` at
the repository root, named by a hash of the source and the flags, so an
edited source rebuilds and an unchanged one loads at once. The sources
are compiled in parallel (one nvcc per source, all started together).
No PyTorch header is compiled: that keeps a build to seconds.

``nvcc`` is looked up in ``$CUDA_HOME/bin``, then ``/usr/local/cuda/bin``,
then ``PATH``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Tuple

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(PKG_DIR), "build", "torch_kernels")

#: Kernel sources, by name (``csrc/<name>.cu``).
SOURCES = ("tile_render2", "lookup", "tile_train", "matmul", "block_sort")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_c_void_p = ctypes.c_void_p
_c_int = ctypes.c_int

#: ctypes signatures of each library's exported functions.
_SIGNATURES = {
    "tile_render2": {
        "gr_tile_render2": (
            _c_int,
            [_c_void_p, ctypes.c_longlong] + [_c_void_p] * 7 + [_c_int] * 9
            + [_c_void_p],
        ),
        "gr_tile_render2_state_floats": (ctypes.c_longlong, [_c_int] * 5),
        "gr_cuda_error_string": (ctypes.c_char_p, [_c_int]),
    },
    "lookup": {
        "gr_table_lookup": (
            _c_int,
            [_c_void_p, _c_int, _c_void_p, _c_int, ctypes.c_longlong, _c_void_p,
             _c_void_p],
        ),
        "gr_cuda_error_string": (ctypes.c_char_p, [_c_int]),
    },
    "tile_train": {
        # (pass id, &GrTrainArgs, stream)
        "gr_train_pass": (_c_int, [_c_int, _c_void_p, _c_void_p]),
        "gr_cuda_error_string": (ctypes.c_char_p, [_c_int]),
    },
    "matmul": {
        "gr_matmul": (_c_int, [_c_void_p] * 3 + [_c_int] * 3 + [_c_void_p]),
        "gr_matmul_sm90": (_c_int, [_c_void_p] * 3 + [_c_int] * 3 + [_c_void_p]),
        "gr_cuda_error_string": (ctypes.c_char_p, [_c_int]),
    },
    "block_sort": {
        "gr_block_sort": (
            _c_int,
            [_c_void_p, _c_void_p, _c_void_p, ctypes.c_longlong, _c_int, _c_void_p,
             ctypes.POINTER(_c_int)],
        ),
        "gr_cuda_error_string": (ctypes.c_char_p, [_c_int]),
    },
}

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
#: ptxas report (registers, shared memory, spills) of each build this
#: process ran, by source name.
build_logs: Dict[str, str] = {}


def find_nvcc() -> str:
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    for path in candidates:
        if os.path.isfile(path) and os.access(path, os.X_OK):
            return path
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
        "PATH): the CUDA toolkit is needed to build the port's kernels"
    )


def library_path(name: str) -> str:
    with open(os.path.join(CSRC_DIR, f"{name}.cu"), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}_{digest.hexdigest()[:16]}.so")


def build_all(names: Tuple[str, ...] = SOURCES) -> float:
    """Compile every source whose library is missing, in parallel.
    Returns the wall seconds spent; raises with nvcc's output on failure."""
    todo = [n for n in names if not os.path.exists(library_path(n))]
    if not todo:
        return 0.0
    nvcc = find_nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    t0 = time.perf_counter()
    procs = []
    for name in todo:
        target = library_path(name)
        tmp = f"{target}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, f"{name}.cu")]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        procs.append((name, target, tmp, proc))
    failed = []
    for name, target, tmp, proc in procs:
        log, _ = proc.communicate()
        build_logs[name] = log
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu:\n{log}")
            continue
        os.replace(tmp, target)
    if failed:
        raise RuntimeError("\n".join(failed))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of ``csrc/<name>.cu``'s library, built on first
    use, with every exported function's signature declared."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build_all((name,))
            lib = ctypes.CDLL(library_path(name))
            for fn, (restype, argtypes) in _SIGNATURES[name].items():
                getattr(lib, fn).restype = restype
                getattr(lib, fn).argtypes = argtypes
            _loaded[name] = lib
        return lib
