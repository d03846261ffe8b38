"""Audio I/O: native WAV and FLAC readers with threaded batch loading.

The port's copy of speech_resynth_tpu/dsp/audio_io.py over its own copies of
the C++ sources (``csrc/wavio.cpp``, ``csrc/flac.cpp``), exposed with ctypes.
``read_batch`` fills one padded (N, T) array with a C++ thread pool,
dispatching on the extension (.flac through the native FLAC decoder).

The library is built with ``g++`` at first use into ``<repo>/build/
torch_kernels/`` (``.gitignore`` lists ``build/``), never into the source
tree; its file name carries a hash of the sources, so an edited source is
always rebuilt. Nothing is built when the module is imported.
"""

from __future__ import annotations

import ctypes
import subprocess
import threading
from pathlib import Path
from typing import Sequence, Tuple

import numpy as np

from ..ops.build import cached_library

CSRC = Path(__file__).resolve().parent / "csrc"
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")

_lock = threading.Lock()
_lib = None


def build_library() -> Path:
    """Compile the WAV/FLAC library (or reuse one built from identical sources)."""
    sources = [CSRC / "wavio.cpp", CSRC / "flac.cpp"]

    def compile_to(out: Path) -> None:
        done = subprocess.run(["g++", *GXX_FLAGS, *map(str, sources), "-o", str(out)], capture_output=True, text=True)
        if done.returncode != 0:
            raise RuntimeError(f"g++ failed to build the WAV/FLAC library:\n{done.stdout}{done.stderr}")

    return cached_library("libsrt_wavio", sources, GXX_FLAGS, compile_to)


def _load():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build_library()))
            info_args = [
                ctypes.c_char_p,
                ctypes.POINTER(ctypes.c_uint32),
                ctypes.POINTER(ctypes.c_uint32),
                ctypes.POINTER(ctypes.c_uint64),
            ]
            read_args = [
                ctypes.c_char_p,
                ctypes.POINTER(ctypes.c_float),
                ctypes.c_uint64,
                ctypes.POINTER(ctypes.c_uint32),
                ctypes.POINTER(ctypes.c_uint32),
            ]
            for name in ("wav_info", "flac_info"):
                getattr(lib, name).restype = ctypes.c_int
                getattr(lib, name).argtypes = info_args
            for name in ("wav_read", "flac_read"):
                getattr(lib, name).restype = ctypes.c_int64
                getattr(lib, name).argtypes = read_args
            lib.wav_write.restype = ctypes.c_int
            lib.wav_write.argtypes = [
                ctypes.c_char_p,
                ctypes.POINTER(ctypes.c_float),
                ctypes.c_uint64,
                ctypes.c_uint32,
                ctypes.c_uint32,
            ]
            lib.wav_read_batch.argtypes = [
                ctypes.POINTER(ctypes.c_char_p),
                ctypes.c_uint64,
                ctypes.POINTER(ctypes.c_float),
                ctypes.c_uint64,
                ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_uint32),
                ctypes.c_int,
            ]
            _lib = lib
        return _lib


def info(path: str | Path) -> Tuple[int, int, int]:
    """(sample_rate, channels, frames)."""
    lib = _load()
    fn = lib.flac_info if Path(path).suffix.lower() == ".flac" else lib.wav_info
    sr, ch, frames = ctypes.c_uint32(), ctypes.c_uint32(), ctypes.c_uint64()
    if fn(str(path).encode(), ctypes.byref(sr), ctypes.byref(ch), ctypes.byref(frames)) != 0:
        raise IOError(f"cannot read audio: {path}")
    return sr.value, ch.value, frames.value


def read(path: str | Path) -> Tuple[np.ndarray, int]:
    """-> (float32 (frames,) mono or (frames, channels), sample_rate)."""
    path = Path(path)
    lib = _load()
    is_flac = path.suffix.lower() == ".flac"
    fn = lib.flac_read if is_flac else lib.wav_read
    sr_, ch_, frames_ = info(path)
    if frames_ == 0 and is_flac:  # STREAMINFO may omit total_samples
        frames_ = sr_ * 3600  # one-hour cap
    buf = np.empty(max(frames_, 1) * ch_, np.float32)
    sr, ch = ctypes.c_uint32(), ctypes.c_uint32()
    n = fn(
        str(path).encode(), buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), max(frames_, 1), ctypes.byref(sr), ctypes.byref(ch)
    )
    if n < 0:
        raise IOError(f"cannot read audio: {path}")
    data = buf[: n * ch.value]
    if ch.value > 1:
        data = data.reshape(-1, ch.value)
    return data, sr.value


def write(path: str | Path, samples: np.ndarray, sample_rate: int) -> None:
    """Write f32 samples in [-1, 1] as a PCM16 WAV, (frames,) or (frames, channels)."""
    samples = np.ascontiguousarray(samples, np.float32)
    channels = 1 if samples.ndim == 1 else samples.shape[1]
    lib = _load()
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    rc = lib.wav_write(
        str(path).encode(), samples.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), samples.shape[0], channels, sample_rate
    )
    if rc != 0:
        raise IOError(f"cannot write wav: {path}")


def read_batch(paths: Sequence[str | Path], max_frames: int, n_threads: int = 0) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Threaded C++ batch load -> (wavs (N, max_frames) f32 mono padded,
    lengths (N,) int64 (-1 on failure), sample_rates (N,) uint32)."""
    lib = _load()
    n = len(paths)
    out = np.zeros((n, max_frames), np.float32)
    lengths = np.zeros(n, np.int64)
    srs = np.zeros(n, np.uint32)
    arr = (ctypes.c_char_p * n)(*[str(p).encode() for p in paths])
    lib.wav_read_batch(
        arr,
        n,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        max_frames,
        lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        srs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        n_threads,
    )
    return out, lengths, srs
