"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Each source compiles with ``nvcc`` for ``sm_90a`` into a shared library with
a plain C interface, which ``ctypes`` loads. The library's file name carries
a hash of the source and the flags, so an edit rebuilds; the output goes to
``_build/`` inside the package (listed in ``.gitignore``). Nothing builds at
import: the first launch of a kernel builds it, or a caller builds it ahead
with :func:`build`. A missing ``nvcc`` or a failed compile raises.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_LIBS: dict = {}
# nvcc's output (ptxas register and shared-memory report) per built kernel
BUILD_LOG: dict = {}


def _nvcc() -> str:
    cands = [shutil.which("nvcc")]
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root:
            cands.append(os.path.join(root, "bin", "nvcc"))
    for c in cands:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found (looked on PATH, in $CUDA_HOME and "
                       "/usr/local/cuda); it is needed to build the CUDA "
                       "kernels")


def _library_path(name: str) -> str:
    with open(os.path.join(CSRC, name + ".cu"), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}_{digest.hexdigest()[:16]}.so")


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless its up-to-date library exists;
    return the library's path."""
    path = _library_path(name)
    if not os.path.isfile(path):
        nvcc = _nvcc()
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        proc = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, name + ".cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            check=False)
        BUILD_LOG[name] = proc.stdout
        if proc.returncode != 0:
            if os.path.isfile(tmp):
                os.unlink(tmp)
            raise RuntimeError(f"nvcc failed for {name}:\n{proc.stdout}")
        os.replace(tmp, path)  # atomic: another process may build too
    return path


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(build(name))
            _LIBS[name] = lib
        return lib
