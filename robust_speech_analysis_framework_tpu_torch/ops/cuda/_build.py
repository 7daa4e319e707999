"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on its own,
at first use, into ``build/kernels/lib<name>_<hash>.so`` beside the package
(the directory is git-ignored). The file name carries a hash of the source,
so an edited source is rebuilt and a stale library is never loaded.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, List

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "kernels")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
# nvcc's stderr per source (ptxas register/shared-memory report), for logs
build_logs: Dict[str, str] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    candidates = [os.path.join(CUDA_HOME, "bin", "nvcc")] if CUDA_HOME else []
    candidates.append(shutil.which("nvcc") or "")
    for path in candidates:
        if path and os.path.exists(path):
            return path
    raise RuntimeError(
        "nvcc not found: the CUDA kernels are built from source at first use; "
        "set CUDA_HOME or put nvcc on PATH"
    )


def _library_path(name: str) -> str:
    with open(os.path.join(CSRC_DIR, name + ".cu"), "rb") as fh:
        digest = hashlib.sha256(fh.read()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"lib{name}_{digest}.so")


def _start(name: str, out: str) -> subprocess.Popen:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, name + ".cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _finish(name: str, out: str, proc: subprocess.Popen) -> None:
    stdout, stderr = proc.communicate()
    build_logs[name] = stdout + stderr
    tmp = f"{out}.{os.getpid()}.tmp"
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{stdout}{stderr}")
    os.replace(tmp, out)  # atomic: a concurrent process never sees half a file


def sources() -> List[str]:
    return sorted(f[:-3] for f in os.listdir(CSRC_DIR) if f.endswith(".cu"))


def build_all() -> None:
    """Compile every source that has no up-to-date library, all at once."""
    with _lock:
        pending = [(n, _library_path(n)) for n in sources()]
        pending = [(n, out) for n, out in pending if not os.path.exists(out)]
        procs = [(n, out, _start(n, out)) for n, out in pending]
        for n, out, proc in procs:
            _finish(n, out, proc)


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building it if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            out = _library_path(name)
            if not os.path.exists(out):
                _finish(name, out, _start(name, out))
            lib = _loaded[name] = ctypes.CDLL(out)
        return lib


def _ctype(arg):
    import torch

    if isinstance(arg, torch.Tensor):
        return ctypes.c_void_p
    return ctypes.c_float if isinstance(arg, float) else ctypes.c_int


def call(lib: str, fn_name: str, device, *args) -> None:
    """Call a C entry point of ``csrc/<lib>.cu``: tensors as pointers, ints
    as ints, floats as floats, the current stream of ``device`` last; raise
    on a CUDA error."""
    import torch

    fn = getattr(load(lib), fn_name)
    fn.argtypes = [_ctype(a) for a in args] + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    values = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    with torch.cuda.device(device):
        err = fn(*values, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn_name} launch failed: cudaError {err}")
