"""Build, load and launch the port's CUDA kernels.

Every ``repro_torch/csrc/*.cu`` is compiled by its own ``nvcc`` process,
all started together, and the objects are linked into ONE shared library
with a plain C interface, loaded with ``ctypes`` (no PyTorch headers, so
the build takes seconds, not minutes).  The build runs at first
use -- never at import, so every module imports on a machine without
``nvcc`` or a card -- and lands in ``kernels/_build/`` (git-ignored) under a
name that hashes the sources, so a stale library is never loaded.

Each wrapper launches through :func:`launch`, which raises when the C entry
point reports a CUDA error and counts the launch in :data:`launches` -- or,
on a thread that is capturing a CUDA graph, in the graph's own counter
(:func:`count_into`): a capture runs nothing, and each replay adds the
counts it recorded (:func:`add_launches`), so :data:`launches` stays the
number of kernels that ran.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time
from collections import Counter

import torch

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC"]

# storage dtypes the kernels take (dtype codes of csrc/common.cuh)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
SIGNATURES = {
    "rmsnorm_launch": [_P, _P, _P, _I, _I, _F, _I, _I, _P],
    "decode_attention_launch": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                _I, _L, _L, _L, _I, _I, _F, _I, _P],
    "paged_decode_attention_launch": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                      _I, _I, _I, _I, _L, _L, _L, _F, _I, _P],
    "paged_mla_decode_attention_launch": [_P, _P, _P, _P, _P, _P, _P, _P, _P,
                                          _I, _I, _I, _I, _I, _I, _I,
                                          _L, _L, _L, _L, _F, _I, _P],
    "flash_attention_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                               _L, _L, _L, _L, _L, _L, _L, _L, _L, _L, _L, _L,
                               _I, _F, _I, _P],
    "ssd_intra_launch": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                         ctypes.POINTER(_L), _I, _I, _P],
    "ssd_slab_decode_launch": [_P, _P, _P, _P, _P, _P, _P, _P, _P,
                               _I, _I, _I, _I, _I, _I,
                               _L, _L, _L, _L, _L, _L, _L, _L, _I, _P],
}

# kernel name -> launches since the last reset (a launch counts only once
# its C entry point reported success)
launches: Counter = Counter()
_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
# per thread: the counter of the CUDA graph this thread is capturing
_capture = threading.local()


def _sources() -> list[pathlib.Path]:
    return sorted(CSRC.glob("*.cu"))


def _library_path() -> pathlib.Path:
    digest = hashlib.sha1()
    for path in sorted(CSRC.glob("*.cu*")):
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libreprotorch_kernels-{digest.hexdigest()[:16]}.so"


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return nvcc


def build() -> float:
    """Compile the kernels if the library for the current sources is
    missing; returns the seconds the build took (0.0 when up to date)."""
    with _lock:
        return _build_locked()


def _build_locked() -> float:
    out = _library_path()
    if out.exists():
        return 0.0
    nvcc = _nvcc()
    objs = BUILD_DIR / f"objects-{os.getpid()}"
    objs.mkdir(parents=True, exist_ok=True)
    t0 = time.monotonic()
    procs = []
    for src in _sources():
        obj = objs / f"{src.stem}.o"
        procs.append((src, obj, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    failed = []
    for src, _, proc in procs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{src.name} ({proc.returncode}):\n{err}")
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    link = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
                           *(str(obj) for _, obj, _ in procs)],
                          capture_output=True, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({link.returncode}):\n"
                           f"{link.stderr}")
    os.replace(tmp, out)
    shutil.rmtree(objs)
    return time.monotonic() - t0


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            _build_locked()
            lib = ctypes.CDLL(str(_library_path()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.kernels_error_string.argtypes = [ctypes.c_int]
            lib.kernels_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def launch(name: str, entry: str, *args) -> None:
    """Call C entry point ``entry`` and count one launch of kernel
    ``name``; raises if it reports a CUDA error."""
    lib = library()
    err = getattr(lib, entry)(*args)
    if err != 0:
        msg = lib.kernels_error_string(err).decode()
        raise RuntimeError(f"{entry} failed: CUDA error {err} ({msg})")
    counter = getattr(_capture, "counter", None)
    with _lock:
        (launches if counter is None else counter)[name] += 1


@contextlib.contextmanager
def count_into(counter: Counter):
    """Launches made on this thread inside the block count in ``counter``,
    not in :data:`launches` (the kernels a graph capture records run only
    when the graph is replayed)."""
    prev = getattr(_capture, "counter", None)
    _capture.counter = counter
    try:
        yield counter
    finally:
        _capture.counter = prev


def add_launches(counts: Counter) -> None:
    """Count ``counts`` launches at once: one replay of a captured graph."""
    with _lock:
        launches.update(counts)


def reset_launches() -> None:
    with _lock:
        launches.clear()


def stream_of(t: torch.Tensor) -> int:
    """The current CUDA stream of ``t``'s device, as the handle the C entry
    points take."""
    return torch.cuda.current_stream(t.device).cuda_stream


def kernel_dtype(*tensors: torch.Tensor) -> int:
    """The dtype code for tensors that must share one supported dtype."""
    dt = tensors[0].dtype
    if dt not in DTYPE_CODES or any(t.dtype != dt for t in tensors):
        raise TypeError("kernel inputs must share one dtype of "
                        f"{sorted(map(str, DTYPE_CODES))}; got "
                        f"{[str(t.dtype) for t in tensors]}")
    return DTYPE_CODES[dt]


def on_cpu(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on the CPU, or on the meta device, which
    holds no values (the plain version serves them: static pricing runs
    the model there); False when all lie on one CUDA device (the kernel
    launches).  Anything else raises: no wrapper falls back from a CUDA
    tensor."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"kernel inputs on several devices: {devices}")
    dev = devices.pop()
    if dev.type in ("cpu", "meta"):
        return True
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    return False


def check_unit_stride(name: str, t: torch.Tensor) -> None:
    if t.stride(-1) != 1:
        raise ValueError(f"{name}: the last axis must be unit-stride, got "
                         f"strides {t.stride()}")


def is_aligned(t: torch.Tensor) -> bool:
    """Whether ``t`` can be copied 16 bytes at a time: its base and the
    strides of its axes but the last (unit) one are multiples of 16 bytes
    (an axis of size 1 is never stepped, so its stride is free)."""
    el = t.element_size()
    strides = [st for st, n in zip(t.stride()[:-1], t.shape[:-1]) if n > 1]
    return not (t.data_ptr() % 16 or any(st * el % 16 for st in strides))


def check_aligned(name: str, t: torch.Tensor) -> None:
    """Raises unless :func:`is_aligned` (the tensor-core kernels copy 16
    bytes at a time)."""
    if not is_aligned(t):
        el = t.element_size()
        raise ValueError(f"{name}: base and strides must be 16-byte aligned, "
                         f"got base {t.data_ptr():#x} % 16 = "
                         f"{t.data_ptr() % 16}, strides {t.stride()} of "
                         f"{el}-byte elements")


def check_index(name: str, t: torch.Tensor, shape: tuple) -> None:
    if t.dtype != torch.int32 or tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous int32 tensor of shape "
                         f"{shape}, got {t.dtype} {tuple(t.shape)}")
