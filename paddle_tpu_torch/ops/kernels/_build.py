"""Build and load the port's CUDA kernels (``paddle_tpu_torch/csrc``).

``nvcc`` compiles every ``csrc/*.cu`` for ``sm_90a`` — one process per
source, all started together — and links them into one shared library
with a plain C interface, loaded with ``ctypes``. The library lives under
``build/paddle_tpu_torch/<hash>/`` at the repository root (ignored by git),
keyed by a hash of the sources and flags, and is built at first use. A
build failure, or a nonzero CUDA error code from an entry point, raises.

Importing this module builds nothing; the CPU tests never call it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_CSRC = Path(__file__).resolve().parents[2] / "csrc"
_BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "paddle_tpu_torch"
_ARCH = "-gencode=arch=compute_90a,code=sm_90a"
_NVCC_FLAGS = ("-std=c++17", "-O3", _ARCH, "-Xcompiler", "-fPIC",
               "-Xptxas", "-v")
_LIB_NAME = "libpaddle_tpu_torch_kernels.so"

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_L = ctypes.c_longlong
#: C entry points and their argument types (each returns a cudaError_t)
_SIGNATURES = {
    "pt_flash_attention_fwd": [_P] * 7 + [_I] * 6 + [_F, _P],
    "pt_norm_matmul": [_P] * 5 + [_I] * 3 + [_F, _P],
    "pt_norm_matmul_quant": [_P] * 6 + [_I] * 5 + [_F, _P],
    "pt_quant_matmul": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "pt_quant_matmul_items": [_I] * 4 + [_P, _P],
    "pt_small_matmul_items": [_I, _I, _P, _P],
    "pt_rope_append_attend_decode": [_P] * 11 + [_I] * 7 + [_F, _P],
    "pt_rope_append_attend_decode_int8": [_P] * 13 + [_I] * 7 + [_F, _P],
    "pt_rope_append_attend_ragged": [_P] * 15 + [_I] * 8 + [_F, _P],
    "pt_rope_append_attend_ragged_int8": [_P] * 17 + [_I] * 8 + [_F, _P],
    "pt_paged_attention": [_P] * 6 + [_I] * 6 + [_F, _P],
    "pt_paged_attention_int8": [_P] * 8 + [_I] * 6 + [_F, _P],
    "pt_paged_walk_items": [_P, _P] + [_I] * 4 + [_P],
    "pt_ragged_paged_attention": [_P] * 12 + [_I] * 7 + [_F, _P],
    "pt_ragged_paged_attention_int8": [_P] * 14 + [_I] * 7 + [_F, _P],
    "pt_ragged_items": [_P] * 4 + [_I] * 6 + [_P],
    "pt_ragged_paged_attention_plan": [_I] * 6 + [_P],
    "pt_ragged_paged_attention_int8_plan": [_I] * 6 + [_P],
    "pt_rope_append_attend_ragged_plan": [_I] * 6 + [_P],
    "pt_rope_append_attend_ragged_int8_plan": [_I] * 6 + [_P],
    "pt_flash_bwd_delta": [_P] * 3 + [_I] * 3 + [_P],
    "pt_flash_attention_bwd": [_P] * 11 + [_I] * 6 + [_F, _P],
    "pt_flash_attention_bwd_fused": [_P] * 12 + [_I] * 7 + [_F, _P],
    "pt_rope": [_P] * 4 + [_I] * 13 + [_P],
    "pt_rms_norm_fwd": [_P] * 4 + [_I, _I, _F, _P],
    "pt_rms_norm_bwd": [_P] * 7 + [_I, _I, _I, _P],
    "pt_adamw8bit": [_P, _I] + [_P] * 6 + [_L] + [_F] * 9 + [_I, _P],
    "pt_grouped_matmul": [_P] * 4 + [_I] * 5 + [_P],
    "pt_group_tile_walk": [_P] + [_I] * 6 + [_P] * 5,
    "pt_segment_dw": [_P] * 4 + [_I] * 4 + [_F, _I, _P],
    "pt_grouped_matmul_quant": [_P] * 5 + [_I] * 6 + [_P],
    "pt_grouped_matmul_items": [_P] + [_I] * 5 + [_P, _P],
    "pt_segment_dw_items": [_P] + [_I] * 4 + [_P, _P],
}

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None:
        from torch.utils.cpp_extension import CUDA_HOME

        if CUDA_HOME:
            path = os.path.join(CUDA_HOME, "bin", "nvcc")
    if not path or not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           "build paddle_tpu_torch's kernels")
    return path


def library_path() -> Path:
    """Where the library for the current sources lives (built or not)."""
    h = hashlib.sha256(" ".join(_NVCC_FLAGS).encode())
    for p in sorted(_CSRC.glob("*.cu")) + sorted(_CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return _BUILD_ROOT / h.hexdigest()[:16] / _LIB_NAME


def build() -> Path:
    """Compile and link the kernels unless the library for the current
    sources exists. Returns its path; the compiler's report (registers,
    shared memory, spills per kernel) is in ``build.log`` beside it."""
    lib = library_path()
    if lib.exists():
        return lib
    out_dir = lib.parent
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    jobs = []
    for src in sorted(_CSRC.glob("*.cu")):
        obj = out_dir / f"{src.stem}.{os.getpid()}.o"
        cmd = [nvcc, *_NVCC_FLAGS, "-I", str(_CSRC), "-c", str(src),
               "-o", str(obj)]
        jobs.append((src.name, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs, failed = [], []
    for name, _, proc in jobs:
        out, _ = proc.communicate()
        logs.append(f"== {name}\n{out}")
        if proc.returncode != 0:
            failed.append(name)
    log = "\n".join(logs)
    (out_dir / "build.log").write_text(log)
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n{log}")
    tmp = out_dir / f"{_LIB_NAME}.{os.getpid()}.tmp"
    link = subprocess.run(
        [nvcc, _ARCH, "-shared", "-o", str(tmp), *(str(o) for _, o, _ in jobs)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"linking the kernels failed:\n{link.stdout}")
    os.replace(tmp, lib)
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.pt_error_string.argtypes = [ctypes.c_int]
            lib.pt_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def launch(name: str, *args) -> None:
    """Call C entry point ``name``; raise if it reports a CUDA error."""
    lib = library()
    rc = getattr(lib, name)(*args)
    if rc != 0:
        raise RuntimeError(f"{name} failed: CUDA error {rc} "
                           f"({lib.pt_error_string(rc).decode()})")


def stream_of(t) -> int:
    """The handle of PyTorch's current stream on ``t``'s device."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream


def check_cuda(name: str, t, dtype=None, shape=None) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype``/``shape``."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if dtype is not None and t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: data pointer not 16-byte aligned")


def check_no_grad(name: str, *tensors) -> None:
    """Raise if autograd would record a kernel call on these tensors: the
    ctypes launch is invisible to autograd, so its gradient would be lost
    silently. Trainable paths reach the kernels through their
    ``torch.autograd.Function``s, whose forward runs with grad off."""
    import torch

    if torch.is_grad_enabled() and any(
            getattr(t, "requires_grad", False) for t in tensors):
        raise RuntimeError(
            f"{name}: a kernel launch on tensors that require grad would "
            f"drop their gradient; call it through its autograd.Function "
            f"or under torch.no_grad()")
