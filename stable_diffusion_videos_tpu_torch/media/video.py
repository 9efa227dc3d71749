"""Streaming video assembly (frames -> mp4, + audio mux) and video
reading.

Counterpart of ``stable_diffusion_videos_tpu/media/video.py`` as far as
``walk()`` and ``vid2vid()`` reach: ``FrameWriter``, ``iter_frames``,
``make_video``, ``probe_video`` and ``read_video_frames``.  Frames stream
to the encoder one at a time, so encoding overlaps generation and memory
stays one frame.

Backend ladder (first available wins):
1. ``ffmpeg`` subprocess pipe: H.264 crf=10 yuv420p + AAC audio mux.
2. the native sink (``native/sdv_media.cpp`` via ctypes): threaded MJPEG
   encode and a RIFF/AVI muxer with interleaved PCM audio; selected when
   audio must be muxed and ffmpeg is absent (output becomes ``.avi``).
3. OpenCV ``VideoWriter`` (mp4v): silent video; audio goes to a sidecar
   ``.wav`` with a warning.

Decode ladder, the same order: ``cv2.VideoCapture``, an ``ffmpeg`` rawvideo
pipe, and a pure-Python reader of the native sink's own MJPEG/AVI ('00dc'
JPEG chunks in a RIFF 'movi' list, decoded by PIL).
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


# ---------------------------------------------------------------------------
# decode: the input side of vid2vid
# ---------------------------------------------------------------------------

def _iter_riff_chunks(buf: bytes, start: int, end: int):
    """Yield (fourcc, payload_start, payload_size) walking a RIFF range."""
    pos = start
    while pos + 8 <= end:
        fourcc = buf[pos:pos + 4]
        size = int.from_bytes(buf[pos + 4:pos + 8], "little")
        yield fourcc, pos + 8, size
        pos += 8 + size + (size & 1)  # chunks are word-aligned


def _read_native_avi(path):
    """Decode our native sink's MJPEG/AVI ('00dc' JPEG chunks) with PIL.

    Returns (fps, iterator-of-uint8-RGB-frames).  Only supports the subset
    our own muxer writes; foreign AVIs should go through cv2/ffmpeg."""
    import io
    from PIL import Image
    buf = Path(path).read_bytes()
    if buf[:4] != b"RIFF" or buf[8:12] != b"AVI ":
        raise ValueError(f"{path} is not a RIFF/AVI file")
    fps = 30.0
    exact_fps = None
    frames = []

    def walk(start, end):
        nonlocal fps, exact_fps
        for fourcc, p, size in _iter_riff_chunks(buf, start, end):
            if fourcc == b"LIST":
                walk(p + 4, p + size)
            elif fourcc == b"avih" and size >= 4:
                usec = int.from_bytes(buf[p:p + 4], "little")
                if usec:
                    fps = 1e6 / usec
            elif (fourcc == b"strh" and size >= 28
                    and buf[p:p + 4] == b"vids"):
                # the video strh carries the EXACT rational (scale @20,
                # rate @24) the muxer was given — the avih usec/frame field
                # is integer-truncated (sdv_media.cpp writes
                # 1000000*den/num), so 29.97 would read back ~29.9706
                scale = int.from_bytes(buf[p + 20:p + 24], "little")
                rate = int.from_bytes(buf[p + 24:p + 28], "little")
                if scale and rate:
                    exact_fps = rate / scale
            elif fourcc == b"00dc":
                frames.append((p, size))

    walk(12, len(buf))
    if exact_fps is not None:
        fps = exact_fps

    def gen():
        for p, size in frames:
            img = Image.open(io.BytesIO(buf[p:p + size]))
            yield np.asarray(img.convert("RGB"))

    return fps, gen()


def _is_native_avi(path) -> bool:
    """True when ``path`` looks like an MJPEG AVI the pure-Python reader
    can decode: RIFF/AVI magic AND an MJPG 'vids' stream header (our muxer
    writes fccType/fccHandler contiguously — ``sdv_media.cpp:214-215``).
    A bare RIFF/AVI magic check is NOT enough: foreign codecs (XVID,
    h264-in-AVI) must keep falling through to the cv2/ffmpeg rungs."""
    try:
        with open(str(path), "rb") as f:
            head = f.read(8192)
    except OSError:
        return False
    return (head[:4] == b"RIFF" and head[8:12] == b"AVI "
            and b"vidsMJPG" in head)


def _probe_via_ffmpeg(path) -> Optional[dict]:
    """Parse ``ffmpeg -i`` stderr for the video stream's WxH and fps.

    Keeps the decode ladder working for foreign containers (mp4/mkv/webm)
    when cv2 is absent — no ffprobe dependency.  Returns None when ffmpeg
    is missing or no video stream is reported; n_frames is 0 (unknown)."""
    import re
    ffmpeg = _find_ffmpeg()
    if not ffmpeg:
        return None
    try:
        proc = subprocess.run([ffmpeg, "-hide_banner", "-i", str(path)],
                              capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return None
    for line in proc.stderr.splitlines():
        if "Video:" not in line:
            continue
        m = re.search(r"\b(\d{2,5})x(\d{2,5})\b", line.split("Video:", 1)[1])
        if not m:
            continue
        # 'fps' is the container rate; 'tbr' is ffmpeg's estimate when the
        # container carries none.  fps=None when NEITHER is reported —
        # never a fabricated 30.0 (callers treat None as unknown)
        fm = (re.search(r"([\d.]+)\s*fps", line)
              or re.search(r"([\d.]+)\s*tbr", line))
        fps = float(fm.group(1)) if fm else None
        return dict(fps=fps, n_frames=0,
                    width=int(m.group(1)), height=int(m.group(2)))
    return None


def probe_video(path) -> dict:
    """{'fps', 'n_frames', 'width', 'height'} for a video file.

    Probe ladder mirrors the decode ladder: cv2 -> pure-Python native-AVI
    reader (for MJPEG AVIs only — exact rational fps + real frame count,
    which the ffmpeg stderr parse cannot provide; foreign-codec AVIs fall
    through like any other container) -> ffmpeg stderr parse.
    n_frames may be 0 when the container (or the ffmpeg probe) does not
    carry a count."""
    path = str(path)
    try:
        import cv2
        cap = cv2.VideoCapture(path)
        if cap.isOpened():
            info = dict(fps=float(cap.get(cv2.CAP_PROP_FPS)) or 30.0,
                        n_frames=int(cap.get(cv2.CAP_PROP_FRAME_COUNT)),
                        width=int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)),
                        height=int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT)))
            cap.release()
            if info["width"] > 0:
                return info
    except ImportError:
        pass
    if not _is_native_avi(path):
        info = _probe_via_ffmpeg(path)
        if info is not None:
            return info
    fps, gen = _read_native_avi(path)
    first = next(iter(gen), None)
    n = 1 if first is not None else 0
    for _ in gen:
        n += 1
    h, w = (first.shape[:2] if first is not None else (0, 0))
    return dict(fps=fps, n_frames=n, width=w, height=h)


def read_video_frames(path, size=None, frame_skip: int = 1,
                      max_frames: Optional[int] = None):
    """Yield uint8 RGB (H, W, 3) frames from a video file.

    size: optional (height, width) to bilinear-resize each frame to.
    frame_skip: keep every k-th frame.  max_frames: stop after N yielded.

    Decode ladder: cv2.VideoCapture -> ffmpeg rawvideo pipe -> the
    pure-Python reader for our native MJPEG/AVI container."""
    path = str(path)
    if not Path(path).exists():
        raise FileNotFoundError(path)

    def _resize(frame):
        if size is None or frame.shape[:2] == tuple(size):
            return frame
        from PIL import Image
        return np.asarray(Image.fromarray(frame).resize(
            (size[1], size[0]), Image.BILINEAR))

    def _emit(source):
        yielded = 0
        for i, frame in enumerate(source):
            if i % frame_skip:
                continue
            yield _resize(frame)
            yielded += 1
            if max_frames is not None and yielded >= max_frames:
                return

    try:
        import cv2
        cap = cv2.VideoCapture(path)
        if cap.isOpened():
            def cv2_source():
                try:
                    while True:
                        ok, bgr = cap.read()
                        if not ok:
                            return
                        yield np.ascontiguousarray(bgr[..., ::-1])
                finally:
                    cap.release()
            probe = cv2.VideoCapture(path)
            ok = probe.isOpened() and probe.read()[0]
            probe.release()
            if ok:
                yield from _emit(cv2_source())
                return
        cap.release()
    except ImportError:
        pass

    ffmpeg = _find_ffmpeg()
    if ffmpeg:
        # rawvideo pipe needs the frame dimensions up front; the probe may
        # itself fall through to the native-AVI reader for our own container,
        # which raises on foreign files — treat that as "unknown" and let the
        # native rung below produce the final error.
        try:
            info = probe_video(path)
        except (ValueError, OSError):
            info = {"width": 0, "height": 0}
        w, h = info["width"], info["height"]
        if w and h:
            cmd = [ffmpeg, "-loglevel", "error", "-i", path,
                   "-f", "rawvideo", "-pix_fmt", "rgb24", "-"]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE)

            def ffmpeg_source():
                nbytes = w * h * 3
                try:
                    while True:
                        raw = proc.stdout.read(nbytes)
                        if len(raw) < nbytes:
                            return
                        yield np.frombuffer(raw, np.uint8).reshape(h, w, 3)
                finally:
                    proc.stdout.close()
                    proc.wait()
            yield from _emit(ffmpeg_source())
            return

    _, gen = _read_native_avi(path)
    yield from _emit(gen)
