"""Build the port's compiled sources and load them with ctypes.

Two toolchains share one scheme. ``CUDA`` compiles each ``csrc/<name>.cu``
with nvcc into ``build/torch_kernels/``; ``NATIVE`` compiles the host C++
readers, each ``native/<name>.cpp``, with g++ into ``build/torch_native/``
(both at the repository root). Every source exports a plain C interface
and is compiled on first use into its own shared library, named by a hash
of the source, the flags and the compiler (its path and ``--version``), so
an edited source or another compiler rebuilds and an unchanged one loads
at once. Sources compile in parallel (one compiler process per source, all
started together), each into a per-process temporary file that
``os.replace`` moves into place. No PyTorch header is compiled: that keeps
a build to seconds. A missing compiler or a failed build raises with the
compiler's output; nothing falls back quietly to a slower path.

``nvcc`` is looked up in ``$CUDA_HOME/bin``, then ``/usr/local/cuda/bin``,
then ``PATH``. The native readers build with ``g++`` on ``PATH``, as in
the JAX package, and with its flags (``-O3 -shared -fPIC -std=c++17``):
neither ``-ffast-math`` nor ``-march=native``, which would change how
``std::exp`` rounds and so the loaded opacities and scales. ``$CXX`` is
not read: one set for other builds may name a compiler wrapper whose
shared libraries crash when ctypes calls into them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Callable, Dict, Tuple

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
NATIVE_DIR = os.path.join(PKG_DIR, "native")
BUILD_DIR = os.path.join(os.path.dirname(PKG_DIR), "build", "torch_kernels")
NATIVE_BUILD_DIR = os.path.join(os.path.dirname(PKG_DIR), "build", "torch_native")

#: Kernel sources, by name (``csrc/<name>.cu``).
SOURCES = ("tile_render2", "lookup", "tile_train", "matmul", "block_sort", "segment_sum",
           "prng")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_c_void_p = ctypes.c_void_p
_c_int = ctypes.c_int

#: ctypes signatures of each CUDA library's exported functions.
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
        # (a, b, c, m, n, k, a_pack or NULL, b_pack or NULL, stream)
        "gr_matmul": (_c_int, [_c_void_p] * 3 + [_c_int] * 3 + [_c_void_p] * 3),
        "gr_cuda_error_string": (ctypes.c_char_p, [_c_int]),
    },
    "segment_sum": {
        # (rows, d, order (int32), offsets (int32), n, out, stream)
        "gr_segment_sum": (
            _c_int, [_c_void_p, _c_int, _c_void_p, _c_void_p, _c_int, _c_void_p, _c_void_p],
        ),
        "gr_cuda_error_string": (ctypes.c_char_p, [_c_int]),
    },
    "prng": {
        # (key word k1, n, mode, out, stream)
        "gr_prng": (
            _c_int, [ctypes.c_uint, ctypes.c_longlong, _c_int, _c_void_p, _c_void_p],
        ),
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
#: Loaded libraries, by source name (the names of both toolchains differ).
_loaded: Dict[str, ctypes.CDLL] = {}
#: Compiler output (for nvcc, ptxas's registers, shared memory and spills)
#: of each build this process ran, by source name.
build_logs: Dict[str, str] = {}
#: ``path\n--version output`` of each compiler asked, by path.
_identities: Dict[str, str] = {}


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


def find_cxx() -> str:
    """``g++`` on ``PATH``."""
    found = shutil.which("g++")
    if found is None:
        raise RuntimeError(
            "g++ not found on PATH: it is needed to build the port's native "
            "readers"
        )
    return found


def _compiler_identity(compiler: str) -> str:
    ident = _identities.get(compiler)
    if ident is None:
        try:
            version = subprocess.run(
                [compiler, "--version"], capture_output=True, text=True
            ).stdout
        except OSError:
            version = ""  # the build reports the compiler that cannot run
        ident = _identities[compiler] = f"{compiler}\n{version}"
    return ident


class Toolchain:
    """One compiler and its flags, the directory of its sources and the
    one its libraries go to."""

    def __init__(self, find_compiler: Callable[[], str], src_dir: str, ext: str,
                 flags: Tuple[str, ...], build_dir: str):
        self.find_compiler = find_compiler
        self.src_dir = src_dir
        self.ext = ext
        self.flags = flags
        self.build_dir = build_dir

    def source(self, name: str) -> str:
        return os.path.join(self.src_dir, name + self.ext)

    def library_path(self, name: str) -> str:
        digest = hashlib.sha256()
        with open(self.source(name), "rb") as f:
            digest.update(f.read())
        digest.update(" ".join(self.flags).encode())
        digest.update(_compiler_identity(self.find_compiler()).encode())
        return os.path.join(self.build_dir, f"lib{name}_{digest.hexdigest()[:16]}.so")

    def build(self, names: Tuple[str, ...]) -> float:
        """Compile every source whose library is missing, in parallel.
        Returns the wall seconds spent; raises with the compiler's output
        on failure."""
        todo = [(n, self.library_path(n)) for n in names]
        todo = [(n, target) for n, target in todo if not os.path.exists(target)]
        if not todo:
            return 0.0
        compiler = self.find_compiler()
        os.makedirs(self.build_dir, exist_ok=True)
        t0 = time.perf_counter()
        procs = []
        for name, target in todo:
            # A per-process name: several processes may build the same
            # library at once, and none may replace the target with a
            # half-written file.
            tmp = f"{target}.{os.getpid()}.tmp"
            cmd = [compiler, *self.flags, "-o", tmp, self.source(name)]
            proc = subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            )
            procs.append((name, target, tmp, proc))
        failed = []
        for name, target, tmp, proc in procs:
            log, _ = proc.communicate()
            build_logs[name] = log
            if proc.returncode != 0:
                failed.append(f"{compiler} failed for {name}{self.ext} "
                              f"(exit {proc.returncode}):\n{log}")
                continue
            os.replace(tmp, target)
        if failed:
            raise RuntimeError("\n".join(failed))
        return time.perf_counter() - t0

    def load(self, name: str, signatures) -> ctypes.CDLL:
        """The ctypes handle of ``name``'s library, built on first use,
        with ``signatures`` ({function: (restype, argtypes)}) declared."""
        with _lock:
            lib = _loaded.get(name)
            if lib is None:
                self.build((name,))
                lib = ctypes.CDLL(self.library_path(name))
                for fn, (restype, argtypes) in signatures.items():
                    getattr(lib, fn).restype = restype
                    getattr(lib, fn).argtypes = argtypes
                _loaded[name] = lib
            return lib


CUDA = Toolchain(find_nvcc, CSRC_DIR, ".cu", NVCC_FLAGS, BUILD_DIR)
NATIVE = Toolchain(find_cxx, NATIVE_DIR, ".cpp", CXX_FLAGS, NATIVE_BUILD_DIR)


def library_path(name: str) -> str:
    return CUDA.library_path(name)


def build_all(names: Tuple[str, ...] = SOURCES) -> float:
    """Compile every CUDA source whose library is missing, in parallel."""
    return CUDA.build(names)


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of ``csrc/<name>.cu``'s library, built on first
    use, with every exported function's signature declared."""
    return CUDA.load(name, _SIGNATURES[name])
