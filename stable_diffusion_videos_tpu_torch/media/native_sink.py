"""ctypes bridge to the native media runtime (``native/sdv_media.cpp``).

Counterpart of ``stable_diffusion_videos_tpu/media/native_sink.py``.  Builds
``libsdv_media.so`` from the repository's ``native/sdv_media.cpp`` on first
use (g++, seconds) into the port's ``_build/media/`` (listed in
``.gitignore``), and exposes the threaded MJPEG/AVI sink: frames stream in
RGB, JPEG-encode on a worker pool, and mux with interleaved PCM audio, so a
walk writes video with audio without ffmpeg.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
from fractions import Fraction
from pathlib import Path
from typing import Optional

import numpy as np

logger = logging.getLogger("sdv_torch")

_SOURCE = Path(__file__).resolve().parents[2] / "native" / "sdv_media.cpp"
_SO_PATH = Path(__file__).resolve().parents[1] / "_build" / "media" / \
    "libsdv_media.so"
QUALITY = 95    # JPEG quality of a frame
N_THREADS = 4   # JPEG encoder threads
_lib = None
_build_failed = False


def _build() -> bool:
    if not _SOURCE.exists():
        return False
    _SO_PATH.parent.mkdir(parents=True, exist_ok=True)
    # build under a name of this process, then move: a concurrent build
    # never loads a half-written library
    tmp = _SO_PATH.with_suffix(f".{os.getpid()}.so")
    cmd = ["g++", "-O2", "-fPIC", "-shared", "-std=c++17", "-o",
           str(tmp), str(_SOURCE), "-ljpeg", "-lpthread"]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True)
        os.replace(tmp, _SO_PATH)
        return True
    except (subprocess.CalledProcessError, FileNotFoundError) as e:
        logger.warning("native media build failed: %s",
                       getattr(e, "stderr", e))
        return False


def load_native():
    """Load (building if needed) the native library; None if unavailable."""
    global _lib, _build_failed
    if _lib is not None:
        return _lib
    if _build_failed:
        return None
    if not _SO_PATH.exists() or (_SO_PATH.stat().st_mtime
                                 < _SOURCE.stat().st_mtime):
        if not _build():
            _build_failed = True
            return None
    lib = ctypes.CDLL(str(_SO_PATH))
    lib.sdv_sink_open.restype = ctypes.c_void_p
    lib.sdv_sink_open.argtypes = [ctypes.c_char_p] + [ctypes.c_int] * 8
    lib.sdv_sink_add_frame.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.sdv_sink_add_audio.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                       ctypes.c_long]
    lib.sdv_sink_frames.argtypes = [ctypes.c_void_p]
    lib.sdv_sink_frames.restype = ctypes.c_long
    lib.sdv_sink_close.argtypes = [ctypes.c_void_p]
    _lib = lib
    return _lib


def native_available() -> bool:
    return load_native() is not None


class NativeAviSink:
    """Streaming MJPEG/AVI writer with optional PCM16 audio."""

    def __init__(self, path, width: int, height: int, fps: float = 30,
                 audio: Optional[np.ndarray] = None, audio_sr: int = 22050):
        lib = load_native()
        if lib is None:
            raise RuntimeError("native media library unavailable")
        self._lib = lib
        sr, channels = 0, 1
        self._audio16 = None
        if audio is not None:
            a = np.asarray(audio)
            if a.ndim == 1:
                a = a[:, None]
            channels = a.shape[1]
            sr = audio_sr
            self._audio16 = np.ascontiguousarray(
                (np.clip(a, -1, 1) * 32767.0).astype(np.int16))
        # fps goes over the ABI as a rational so fractional source rates
        # (29.97 -> 2997/100) keep exact AVI scale/rate headers
        frac = Fraction(fps).limit_denominator(65535)
        self._h = lib.sdv_sink_open(str(path).encode(), width, height,
                                    frac.numerator, frac.denominator,
                                    QUALITY, N_THREADS, sr, channels)
        if not self._h:
            raise RuntimeError(f"failed to open {path}")
        self.path = str(path)
        self._w, self._ht = width, height
        if self._audio16 is not None:
            lib.sdv_sink_add_audio(
                self._h, self._audio16.ctypes.data_as(ctypes.c_void_p),
                self._audio16.size)

    def add_frame(self, frame: np.ndarray):
        frame = np.asarray(frame)
        if frame.dtype != np.uint8:
            frame = (np.clip(frame, 0, 1) * 255).round().astype(np.uint8)
        if frame.shape[:2] != (self._ht, self._w):
            raise ValueError(f"frame {frame.shape[:2]} != "
                             f"({self._ht}, {self._w})")
        frame = np.ascontiguousarray(frame)
        self._lib.sdv_sink_add_frame(
            self._h, frame.ctypes.data_as(ctypes.c_char_p))

    def close(self) -> str:
        if self._h:
            self._lib.sdv_sink_close(self._h)
            self._h = None
        return self.path
