"""Build and load the hand-written CUDA kernels of the port.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` into ONE shared library
with a plain C interface, loaded with :mod:`ctypes` (no PyTorch headers:
a file that includes ``torch/extension.h`` takes minutes to compile, a
plain C one seconds)::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o build/papc_tpu_torch/<hash>/libpapc_kernels.so csrc/*.cu

The library lands under ``build/`` at the repository root, keyed by a
hash of the sources and flags, and is built at first use, never at
import. A failed build raises; nothing falls back to another path.

Each C entry point launches its kernel on the stream it is given and
returns the ``cudaError_t`` of the launch. :class:`Kernel` wraps one
entry point: it raises on a non-zero return and counts the launches
that succeeded, so a run can show that it went through the kernel.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent.parent / "build" / "papc_tpu_torch"
LIB_NAME = "libpapc_kernels.so"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError(
        "nvcc not found (looked on PATH and in $CUDA_HOME/bin): the "
        "papc_tpu_torch kernels are compiled from csrc/ at first use"
    )


def library_path() -> Path:
    h = hashlib.sha256()
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_ROOT / h.hexdigest()[:16] / LIB_NAME


def build() -> tuple[Path, float]:
    """Compile the kernel library if it is not built yet.

    Returns ``(path, seconds spent compiling)`` (0.0 when the library
    for these sources already existed). The compiler's output, including
    ``-Xptxas -v``'s registers and shared memory per kernel, is kept in
    ``nvcc.log`` beside the library.
    """
    lib = library_path()
    if lib.exists():
        return lib, 0.0
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{LIB_NAME}.{os.getpid()}.tmp")
    cu = [str(s) for s in sources() if s.suffix == ".cu"]
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), *cu]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = lib.with_name("nvcc.log")
    log.write_text(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed (exit {proc.returncode}), log in {log}:\n"
            + proc.stderr[-4000:]
        )
    os.replace(tmp, lib)  # atomic: a concurrent loader never sees half a file
    return lib, seconds


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built first if needed)."""
    lib_path, _ = build()
    lib = ctypes.CDLL(str(lib_path))
    lib.papc_error_string.argtypes = [ctypes.c_int]
    lib.papc_error_string.restype = ctypes.c_char_p
    return lib


class Kernel:
    """One C entry point of the kernel library plus its launch count.

    ``argtypes`` follow ctypes: ``c_void_p`` for every pointer and the
    stream (a bare Python int would be cut to 32 bits), ``c_int`` /
    ``c_float`` for scalars.
    """

    def __init__(self, symbol: str, argtypes: list):
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0

    def __call__(self, *args) -> None:
        fn = getattr(library(), self.symbol)
        fn.argtypes = self.argtypes
        fn.restype = ctypes.c_int
        err = fn(*args)
        if err != 0:
            msg = library().papc_error_string(err).decode()
            raise RuntimeError(f"{self.symbol}: CUDA error {err} ({msg})")
        self.launches += 1


def stream_of(t) -> ctypes.c_void_p:
    """PyTorch's current CUDA stream on ``t``'s device, as a C pointer."""
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr() if t is not None else 0)
