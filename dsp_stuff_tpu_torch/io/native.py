"""ctypes binding to the host library (native/dsp_host.cpp).

The library holds the hot host-side paths: WAV decode / encode with the
sample-format conversions, the 16-tap windowed-sinc resampler (the output
path's analog, devices.rs:550-556), stereo duplication and a lock-free
SPSC ring buffer (the rivulet analog).  Each has a NumPy counterpart
(io/wav.py, io/resample.py, io/playback.py, runtime/stream._PyRing) that
gives the same bits, and the callers take it when the library cannot be
built.

The library is built with ``g++`` (native/Makefile's flags) at first use,
not at import, into ``build/native/`` beside the package, keyed by a hash
of the source and the flags.  Nothing is written into ``native/``.
``available()`` is False when ``g++`` is missing or the build fails.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess

import numpy as np

_ROOT = pathlib.Path(__file__).resolve().parents[2]
SOURCE = _ROOT / "native" / "dsp_host.cpp"
BUILD_DIR = _ROOT / "build" / "native"
CXXFLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-Wall")

_F32P = ctypes.POINTER(ctypes.c_float)


def lib_path() -> pathlib.Path:
    """Where the library built from the current source lives."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXXFLAGS).encode())
    return BUILD_DIR / f"libdsp_host_{h.hexdigest()[:16]}.so"


def _build() -> pathlib.Path | None:
    """The library, built if needed; None when it cannot be built."""
    if not SOURCE.exists():
        return None
    lib = lib_path()
    if lib.exists():
        return lib
    cxx = shutil.which("g++")
    if cxx is None:
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    try:
        r = subprocess.run([cxx, *CXXFLAGS, "-o", str(tmp), str(SOURCE)],
                           capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        return None
    if r.returncode:
        tmp.unlink(missing_ok=True)
        return None
    os.replace(tmp, lib)
    return lib


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL | None:
    """The loaded library with its argument types set, or None (after one
    build attempt)."""
    path = _build()
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(str(path))
    except OSError:
        return None
    c = ctypes
    lib.dsp_free.argtypes = [c.c_void_p]
    lib.dsp_wav_read.argtypes = [
        c.c_char_p, c.POINTER(_F32P), c.POINTER(c.c_int32),
        c.POINTER(c.c_int64), c.POINTER(c.c_int32)]
    lib.dsp_wav_read.restype = c.c_int
    lib.dsp_wav_write.argtypes = [
        c.c_char_p, _F32P, c.c_int32, c.c_int64, c.c_int32, c.c_int32]
    lib.dsp_wav_write.restype = c.c_int
    lib.dsp_resample_sinc16.argtypes = [
        _F32P, c.c_int64, c.c_double, c.POINTER(_F32P)]
    lib.dsp_resample_sinc16.restype = c.c_int64
    lib.dsp_dup_to_stereo.argtypes = [_F32P, _F32P, c.c_int64]
    lib.dsp_ring_new.argtypes = [c.c_int64]
    lib.dsp_ring_new.restype = c.c_void_p
    lib.dsp_ring_free.argtypes = [c.c_void_p]
    for f in ("dsp_ring_read", "dsp_ring_write"):
        getattr(lib, f).argtypes = [c.c_void_p, _F32P, c.c_int64]
        getattr(lib, f).restype = c.c_int64
    for f in ("dsp_ring_readable", "dsp_ring_writable"):
        getattr(lib, f).argtypes = [c.c_void_p]
        getattr(lib, f).restype = c.c_int64
    lib.dsp_ring_drain.argtypes = [c.c_void_p]
    return lib


def available() -> bool:
    return load() is not None


def _lib() -> ctypes.CDLL:
    lib = load()
    if lib is None:
        raise RuntimeError(f"the host library ({SOURCE.name}) could not be "
                           f"built; use the NumPy paths")
    return lib


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(_F32P)


def wav_read(path: str):
    """WAV decode -> ([channels, T] f32, rate).  Raises ValueError on a
    file the decoder refuses."""
    lib = _lib()
    data = _F32P()
    n_ch, n_frames, rate = ctypes.c_int32(), ctypes.c_int64(), ctypes.c_int32()
    rc = lib.dsp_wav_read(str(path).encode(), ctypes.byref(data),
                          ctypes.byref(n_ch), ctypes.byref(n_frames),
                          ctypes.byref(rate))
    if rc != 0:
        raise ValueError(f"dsp_wav_read({path!r}) failed: rc={rc}")
    n = n_ch.value * n_frames.value
    arr = np.ctypeslib.as_array(data, shape=(n,)).copy() if n else \
        np.zeros(0, np.float32)
    lib.dsp_free(data)
    return arr.reshape(n_ch.value, n_frames.value), rate.value


def wav_write(path: str, data, rate: int = 48_000,
              float_format: bool = True) -> None:
    """data [T] or [channels, T] f32 -> IEEE float32 or 16-bit PCM WAV."""
    lib = _lib()
    data = np.ascontiguousarray(np.atleast_2d(np.asarray(data, np.float32)))
    rc = lib.dsp_wav_write(str(path).encode(), _ptr(data), data.shape[0],
                           data.shape[1], rate, 1 if float_format else 0)
    if rc != 0:
        raise ValueError(f"dsp_wav_write({path!r}) failed: rc={rc}")


def resample_sinc16(x, ratio: float) -> np.ndarray:
    """16-tap windowed-sinc resample of a 1-D f32 signal by out/in
    ``ratio``."""
    lib = _lib()
    x = np.ascontiguousarray(np.asarray(x, np.float32))
    out = _F32P()
    n = lib.dsp_resample_sinc16(_ptr(x), x.size, float(ratio),
                                ctypes.byref(out))
    if n < 0:
        raise ValueError("dsp_resample_sinc16 failed")
    arr = np.ctypeslib.as_array(out, shape=(n,)).copy() if n else \
        np.zeros(0, np.float32)
    lib.dsp_free(out)
    return arr


def dup_to_stereo(x) -> np.ndarray:
    """Mono [n] f32 -> interleaved stereo [2n] (devices.rs:476-480)."""
    lib = _lib()
    x = np.ascontiguousarray(np.asarray(x, np.float32))
    out = np.empty(2 * x.size, np.float32)
    lib.dsp_dup_to_stereo(_ptr(x), _ptr(out), x.size)
    return out


class Ring:
    """Lock-free SPSC ring buffer of f32 samples (the rivulet analog).

    The reference's failure modes: a full ring drops the excess on write
    (input overrun, devices.rs:239-241); a short read returns what exists
    (output underrun, devices.rs:436-440); drain() is the resync flush
    (runtime.rs:587-594)."""

    def __init__(self, capacity: int = 8192):   # runtime.rs:568 default
        self._lib = _lib()
        self._h = self._lib.dsp_ring_new(capacity)
        if not self._h:
            raise MemoryError("dsp_ring_new failed")

    def write(self, x) -> int:
        x = np.ascontiguousarray(np.asarray(x, np.float32).ravel())
        return self._lib.dsp_ring_write(self._h, _ptr(x), x.size)

    def read(self, n: int) -> np.ndarray:
        buf = np.empty(n, np.float32)
        got = self._lib.dsp_ring_read(self._h, _ptr(buf), n)
        return buf[:got]

    @property
    def readable(self) -> int:
        return self._lib.dsp_ring_readable(self._h)

    @property
    def writable(self) -> int:
        return self._lib.dsp_ring_writable(self._h)

    def drain(self) -> None:
        self._lib.dsp_ring_drain(self._h)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.dsp_ring_free(self._h)
            self._h = None
