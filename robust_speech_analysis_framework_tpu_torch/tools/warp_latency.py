"""Time one warp's dependent steps on the card: ALU, shuffle and shared-memory
latency, and the lane-exchange patterns the Viterbi chain could use.

    python3 -m robust_speech_analysis_framework_tpu_torch.tools.warp_latency

Needs one CUDA device and ``nvcc``. Builds ``warp_latency.cu`` beside this
file into the git-ignored ``build/kernels/``, runs each kernel on one warp,
and prints the card's name and power limit, the SM clock measured against
the global timer, and nanoseconds and clocks per item.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import torch

from ..ops.cuda import _build

ITEMS = (  # kernel, what one item is, items an iteration
    ("dependent fma", 16), ("dependent shuffle", 16),
    ("8 independent shuffles + tree min + 2 adds", 1),
    ("16 independent shuffles + tree min + 2 adds", 1),
    ("store + 2 float4 loads through shared memory + tree min + 2 adds", 1),
    ("dependent shared-memory load", 16),
)


def _load() -> ctypes.CDLL:
    """Build ``warp_latency.cu`` into the kernels' build directory and load it."""
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    lib_path = os.path.join(_build.BUILD_DIR, "libwarp_latency.so")
    source = os.path.join(os.path.dirname(os.path.abspath(__file__)), "warp_latency.cu")
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", lib_path, source], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(lib_path)
    lib.run.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    return lib


def _launcher(lib: ctypes.CDLL):
    stream = torch.cuda.current_stream().cuda_stream

    def launch(which: int, buf: torch.Tensor, n: int) -> None:
        err = lib.run(which, buf.data_ptr(), n, stream)
        if err != 0:
            raise RuntimeError(f"launch failed: cudaError {err}")

    return launch


def sm_clock_ghz(lib: ctypes.CDLL = None, n: int = 1_000_000) -> tuple:
    """(GHz, clocks a dependent fma): one warp's ``clock64()`` against the
    global timer over n · 16 dependent FMAs."""
    launch = _launcher(lib or _load())
    counts = torch.zeros(8, dtype=torch.int64, device="cuda")
    launch(6, counts, n)
    torch.cuda.synchronize()
    clocks, nanos = counts[:2].tolist()
    return clocks / nanos, clocks / n / 16


def main() -> int:
    if not torch.cuda.is_available():
        print("warp_latency: needs one CUDA device", file=sys.stderr)
        return 1
    lib = _load()
    launch = _launcher(lib)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    ghz, per_fma = sm_clock_ghz(lib)
    print(f"SM clock {ghz:.3f} GHz; {per_fma:.2f} clocks a dependent fma")

    buf = torch.zeros(64, device="cuda")
    n = 100_000
    for which, (name, per) in enumerate(ITEMS):
        launch(which, buf, n)  # warm-up
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(3):
            launch(which, buf, n)
        end.record()
        torch.cuda.synchronize()
        ns = start.elapsed_time(end) / 3 * 1e6 / n / per
        print(f"{name}: {ns:.2f} ns, {ns * ghz:.0f} clocks")
    return 0


if __name__ == "__main__":
    sys.exit(main())
