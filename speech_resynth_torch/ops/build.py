"""Build and load the port's hand-written CUDA kernels.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` (one process per
source, all started together) and linked into one shared library with a
plain C interface, which ``ctypes`` loads. Nothing here includes PyTorch's
headers, so a cold build takes seconds. The library goes to
``<repo>/build/torch_kernels/``, which ``.gitignore`` lists (``build/``); its
file name carries a hash of the sources, the shared headers (``csrc/*.cuh``)
and the flags, so an edited source or header is always rebuilt. The TMA
tensor maps come from the CUDA driver through ``cudaGetDriverEntryPointByVersion``,
so the link needs no ``-lcuda``.

Nothing is built or loaded at import time: the first kernel launch calls
:func:`kernel_library`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, Optional, Sequence

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong

# C entry points: name -> argtypes. Each returns the cudaError_t of its launch.
SIGNATURES = {
    # q, k, v, mask (nullable), out, B, H, Nq, Nk, D, is_bf16, causal, scale, stream
    "srt_flash_attention": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _P],
    # x, w1, b1, w2, b2, out, B, C, T, K, n_pairs, d0, d1, d2, is_bf16, slope, stream (the tile is planned in C)
    "srt_mrf_branch": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _P],
    # B, C, T, K, n_pairs, d0, d1, d2, is_bf16, plan (host int[4]: t_tile, window, shared bytes, SMs)
    "srt_mrf_branch_plan": [_I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    # x, w1, b1, w2, b2 (each branch's, concatenated), out, scratch, its floats, B, C, T, n_branches,
    # shapes (host int[5 * n_branches]: K, n_pairs, d0, d1, d2), is_bf16, slope, stream (the tile is planned in C)
    "srt_mrf_stage": [_P, _P, _P, _P, _P, _P, _P, _L, _I, _I, _I, _I, _P, _I, _F, _P],
    # B, C, T, n_branches, shapes, is_bf16, plan (host int[4]: t_tile, window, shared bytes, SMs)
    "srt_mrf_stage_plan": [_I, _I, _I, _I, _P, _I, _P],
    # out (host int64): the f32 floats of K3's scratch on the current card
    "srt_mrf_stage_scratch_floats": [_P],
    # x (N, D), c_hi (K, D), c_lo (K, D), half_sq, packed (scratch), ids, N, D, K, x_is_bf16, stream
    "srt_codebook_assign": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
}


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(found).is_file():
        raise RuntimeError("nvcc not found: the port's CUDA kernels are built on a machine with the CUDA toolkit")
    return found


def cached_library(stem: str, sources: Sequence[Path], flags: Sequence[str], compile_to: Callable[[Path], None]) -> Path:
    """``BUILD_DIR/<stem>_<hash>.so``, the hash taken over ``flags`` and the
    sources (every file the build reads): reused when it exists, else ``compile_to(tmp)`` writes it to a
    temporary path that then replaces it atomically, so a concurrent loader
    never sees a partial file."""
    digest = hashlib.sha256(" ".join(flags).encode())
    for src in sources:
        digest.update(src.name.encode() + src.read_bytes())
    lib_path = BUILD_DIR / f"{stem}_{digest.hexdigest()[:16]}.so"
    if lib_path.is_file():
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
    compile_to(tmp)
    os.replace(tmp, lib_path)
    return lib_path


def _nvcc_build(sources: Sequence[Path], out: Path) -> None:
    """Compile each source in its own ``nvcc`` (all started together), then link."""
    nvcc = _nvcc()
    obj_dir = out.with_suffix(".obj")
    obj_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    for src in sources:
        obj = obj_dir / (src.stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    objs, failures = [], []
    for src, obj, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"{src.name}:\n{log}")
        objs.append(str(obj))
    if failures:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
    link = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", *objs, "-o", str(out)], capture_output=True, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
    shutil.rmtree(obj_dir, ignore_errors=True)


def build_library() -> Path:
    """Compile every ``csrc/*.cu`` (in parallel) and link them; returns the
    library path. Reuses an existing library built from identical sources and
    headers."""
    sources = sorted(CSRC.glob("*.cu"))
    headers = sorted(CSRC.glob("*.cuh"))
    return cached_library("libsrt_kernels", sources + headers, NVCC_FLAGS, lambda out: _nvcc_build(sources, out))


def kernel_library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build_library()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.srt_error_string.argtypes = [ctypes.c_int]
            lib.srt_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check_launch(name: str, err: int) -> None:
    """Raise if a C entry point reported a CUDA error for its launch."""
    if err != 0:
        text = kernel_library().srt_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {err} ({text})")


def refuse_grad(name: str, *tensors: torch.Tensor) -> None:
    """Raise where a kernel would be handed a tensor that requires grad while
    grad is on: its output has no ``grad_fn``, so the gradient would be lost
    without a word. Training takes the plain path instead."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise ValueError(f"{name} has no backward: it takes no tensor that requires grad while grad is on")
