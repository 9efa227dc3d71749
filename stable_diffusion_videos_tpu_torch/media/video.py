"""Streaming video assembly: frames -> mp4 (+ audio mux).

Counterpart of the part of ``stable_diffusion_videos_tpu/media/video.py``
that ``walk()`` reaches: ``FrameWriter``, ``iter_frames`` and
``make_video``.  Frames stream to the encoder one at a time, so encoding
overlaps generation and memory stays one frame.

Backend ladder (first available wins):
1. ``ffmpeg`` subprocess pipe: H.264 crf=10 yuv420p + AAC audio mux.
2. the native sink (``native/sdv_media.cpp`` via ctypes): threaded MJPEG
   encode and a RIFF/AVI muxer with interleaved PCM audio; selected when
   audio must be muxed and ffmpeg is absent (output becomes ``.avi``).
3. OpenCV ``VideoWriter`` (mp4v): silent video; audio goes to a sidecar
   ``.wav`` with a warning.
"""

from __future__ import annotations

import logging
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

logger = logging.getLogger("sdv_torch")


def _find_ffmpeg() -> Optional[str]:
    return shutil.which("ffmpeg")


class FrameWriter:
    """Streaming frame sink.  Frames are uint8 RGB (H, W, 3)."""

    def __init__(self, output_filepath, fps: int = 30,
                 audio: Optional[np.ndarray] = None, audio_sr: int = 22050):
        self.output_filepath = str(output_filepath)
        self.fps = fps
        self.audio = audio
        self.audio_sr = audio_sr
        self._n = 0
        self._proc = None
        self._cv2 = None
        self._native = None
        self._shape = None
        if _find_ffmpeg():
            backend = "ffmpeg"
        else:
            from .native_sink import native_available
            if audio is not None and native_available():
                backend = "native"  # only audio-muxing option w/o ffmpeg
            else:
                backend = "cv2"
        if backend == "native":
            # our muxer writes a RIFF/AVI container
            self.output_filepath = str(Path(self.output_filepath)
                                       .with_suffix(".avi"))
        self.backend = backend

    def _open(self, h: int, w: int):
        if self.backend == "native":
            from .native_sink import NativeAviSink
            self._native = NativeAviSink(
                self.output_filepath, w, h, fps=self.fps, audio=self.audio,
                audio_sr=self.audio_sr)
        elif self.backend == "ffmpeg":
            cmd = [_find_ffmpeg(), "-y", "-loglevel", "error",
                   "-f", "rawvideo", "-pix_fmt", "rgb24",
                   "-s", f"{w}x{h}", "-r", str(self.fps), "-i", "-"]
            self._audio_tmp = None
            if self.audio is not None:
                from ..audio.analysis import save_wav
                self._audio_tmp = self.output_filepath + ".tmp.wav"
                save_wav(self._audio_tmp, self.audio, self.audio_sr)
                cmd += ["-i", self._audio_tmp, "-c:a", "aac",
                        "-ar", "44100", "-shortest"]
            cmd += ["-c:v", "libx264", "-crf", "10", "-pix_fmt", "yuv420p",
                    self.output_filepath]
            self._proc = subprocess.Popen(cmd, stdin=subprocess.PIPE)
        else:
            import cv2
            self._cv2 = cv2.VideoWriter(
                self.output_filepath, cv2.VideoWriter_fourcc(*"mp4v"),
                self.fps, (w, h))
            if not self._cv2.isOpened():
                raise RuntimeError(
                    f"cv2.VideoWriter failed to open {self.output_filepath}")
            if self.audio is not None:
                from ..audio.analysis import save_wav
                sidecar = str(Path(self.output_filepath).with_suffix(".wav"))
                save_wav(sidecar, self.audio, self.audio_sr)
                logger.warning(
                    "no ffmpeg binary: audio written as sidecar %s", sidecar)

    def add_frame(self, frame: np.ndarray):
        frame = np.asarray(frame)
        if frame.dtype != np.uint8:
            frame = (np.clip(frame, 0.0, 1.0) * 255).round().astype(np.uint8)
        h, w = frame.shape[:2]
        if self._shape is None:
            self._shape = (h, w)
            self._open(h, w)
        if self.backend == "native":
            self._native.add_frame(frame)
        elif self.backend == "ffmpeg":
            self._proc.stdin.write(frame.tobytes())
        else:
            import cv2
            self._cv2.write(cv2.cvtColor(frame, cv2.COLOR_RGB2BGR))
        self._n += 1

    def close(self) -> str:
        if self.backend == "native":
            if self._native is not None:
                self._native.close()
        elif self.backend == "ffmpeg" and self._proc is not None:
            self._proc.stdin.close()
            ret = self._proc.wait()
            if getattr(self, "_audio_tmp", None):
                Path(self._audio_tmp).unlink(missing_ok=True)
            if ret != 0:
                raise RuntimeError(f"ffmpeg exited with {ret}")
        elif self._cv2 is not None:
            self._cv2.release()
        logger.info("wrote %d frames -> %s", self._n, self.output_filepath)
        return self.output_filepath

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            self.close()


def iter_frames(frames_or_frame_dir, glob_pattern: str = "*.png"):
    """Yield uint8 RGB frames from a directory (sorted glob, recursive
    patterns supported) or an array-like (T, H, W, 3)."""
    from PIL import Image
    if isinstance(frames_or_frame_dir, (str, Path)):
        for img_path in sorted(Path(frames_or_frame_dir).glob(glob_pattern)):
            yield np.asarray(Image.open(img_path).convert("RGB"))
    else:
        for frame in np.asarray(frames_or_frame_dir):
            yield frame


def make_video(frames_or_frame_dir, audio_filepath=None, fps: int = 30,
               audio_offset: float = 0, audio_duration: float = 2,
               sr: int = 22050, output_filepath="output.mp4",
               glob_pattern: str = "*.png") -> str:
    """Reference-compatible assembler (``utils.py:69-128``), streaming.

    frames_or_frame_dir: directory of frames or (T, H, W, 3) array in
    [0, 255] uint8 or [0, 1] float.
    """
    audio = None
    if audio_filepath:
        from ..audio.analysis import load_audio
        audio, sr = load_audio(audio_filepath, sr=sr, offset=audio_offset,
                               duration=audio_duration)
    writer = FrameWriter(output_filepath, fps=fps, audio=audio, audio_sr=sr)
    for frame in iter_frames(frames_or_frame_dir, glob_pattern):
        writer.add_frame(frame)
    return writer.close()
