"""Build the port's CUDA kernels with ``nvcc`` and load them through ``ctypes``.

Every ``ops/csrc/<name>.cu`` is compiled on first use into
``build/autogptq_tpu_torch/lib<name>-<digest>.so`` at the root of the checkout
(``<digest>`` hashes the source, the ``*.cuh`` headers beside it and the flags,
so an edited source is rebuilt and a stale library is never loaded). Each source exports plain C entry
points that take raw device pointers and the CUDA stream, launch on that
stream and return ``cudaGetLastError()``; the Python wrappers raise when the
code is not 0. Nothing is compiled when this module is imported, and a build
or launch failure raises: there is no fallback to the plain versions.

``launches`` counts, per kernel, the wrapper calls that launched it (keyed by
the wrapper's kernel name, not the library's).

A kernel that refuses bad ids on the card (K8a/K8b's page ids, K9's expert
ids) writes nothing for them and ORs a bit into an int32 flag on the device
(:func:`error_flag`); :func:`take_error_bits` reads and clears it when the
host chooses, so no launch waits for the card.

The split-KV attention kernels (K2, K7) keep their partials and ticket
counters in persistent per-device buffers (:func:`split_scratch`), so a call
allocates no scratch and launches one kernel.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "autogptq_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
KERNELS = ("w4a16_gemm", "w8a16_gemm", "w2a16_gemm", "wna16_gemm_t", "w4a16_routed_gemm",
           "w4a16_kb32l_gemm", "flash_decode", "paged_attn", "page_ops")

launches: collections.Counter = collections.Counter()
_flags: dict = {}       # (library, device) -> int32 [1] error flag on the card
_scratch: dict = {}     # (library, device) -> (f32 partials, int32 ticket counters)

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.isfile(path):
        raise RuntimeError("nvcc was not found on PATH or in /usr/local/cuda/bin")
    return path


def library_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):    # shared templates: any edit rebuilds
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names=KERNELS) -> dict[str, float]:
    """Compile the named kernels that are not built yet, one ``nvcc`` per
    source, all started together. Returns the seconds each build took (0 for
    a library that was already there); the compiler's output, with ptxas'
    register and spill counts, is kept in ``BUILD_DIR/<name>.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    seconds = {}
    for name in names:
        target = library_path(name)
        if target.exists():
            seconds[name] = 0.0
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), tmp, target, time.perf_counter())
    failures = []
    for name, (proc, tmp, target, t0) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        (BUILD_DIR / f"{name}.log").write_text(log)
        if proc.returncode != 0:
            failures.append(f"{name}: nvcc exited with {proc.returncode}\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, target)
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build((name,))
            lib = ctypes.CDLL(str(library_path(name)))
            err = getattr(lib, f"{name}_error_string")
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            _libs[name] = lib
        return lib


def _cuda_key(device):
    import torch

    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def error_flag(name: str, device):
    """The int32 ``[1]`` flag on ``device`` into which library ``name``'s
    kernels OR the bits of the bad ids they refused; zero when created."""
    import torch

    key = (name, _cuda_key(device))
    flag = _flags.get(key)
    if flag is None:
        flag = _flags[key] = torch.zeros(1, dtype=torch.int32, device=key[1])
    return flag


def split_scratch(name: str, device, floats: int, rows: int):
    """The f32 partials workspace (at least ``floats``) and the int32 ticket
    counters (at least ``rows``) of library ``name`` on ``device``. Both
    persist and only grow; counters are zero when created and every launch
    leaves them at zero, so launches on one stream may share them."""
    import torch

    key = (name, _cuda_key(device))
    ws, counters = _scratch.get(key, (None, None))
    if ws is None or ws.numel() < floats:
        ws = torch.empty(max(floats, 2 * (0 if ws is None else ws.numel())),
                         dtype=torch.float32, device=key[1])
    if counters is None or counters.numel() < rows:
        counters = torch.zeros(max(rows, 2 * (0 if counters is None else counters.numel())),
                               dtype=torch.int32, device=key[1])
    _scratch[key] = (ws, counters)
    return ws, counters


def take_error_bits(name: str, device) -> int:
    """The bits library ``name``'s kernels set on ``device`` since the last
    call, with the flag cleared; 0 off the card or before any launch. Reading
    the flag waits for the card."""
    device = _cuda_key(device)
    flag = _flags.get((name, device)) if device.type == "cuda" else None
    if flag is None:
        return 0
    bits = int(flag.item())
    if bits:
        flag.zero_()
    return bits


def check(name: str, code: int) -> None:
    """Raise if a C entry point of kernel ``name`` returned a CUDA error."""
    if code != 0:
        msg = getattr(_libs[name], f"{name}_error_string")(code).decode()
        raise RuntimeError(f"{name} launch failed with CUDA error {code}: {msg}")


__all__ = ["BUILD_DIR", "KERNELS", "build", "check", "error_flag", "launches", "library_path",
           "load", "split_scratch", "take_error_bits"]
