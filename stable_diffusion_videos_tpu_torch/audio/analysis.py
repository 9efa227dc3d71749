"""Audio-timed interpolation: the percussive-onset schedule of a clip.

Counterpart of ``stable_diffusion_videos_tpu/audio/analysis.py`` (the
functions ``walk()`` reaches: ``load_audio``, ``get_timesteps_arr`` and
what they call, plus ``save_wav`` for the video muxer).  Host-side numpy and
scipy, without librosa:

    load+resample (22.05 kHz mono) -> STFT(2048, hop 512)
    -> HPSS median-filter soft-mask (percussive part, `margin`)
    -> iSTFT -> mel power spectrogram (128 slaney-norm mel bands)
    -> per-frame max over mel bands -> min-max normalise -> cumsum
    -> resample to duration*fps points -> blend with linspace by `smooth`
"""

from __future__ import annotations

import os

import numpy as np
from scipy import signal as _sig
from scipy.io import wavfile
from scipy.ndimage import median_filter

DEFAULT_SR = 22050


# ---------------------------------------------------------------------------
# Loading
# ---------------------------------------------------------------------------

def load_audio(path, sr: int = DEFAULT_SR, offset: float = 0.0,
               duration: float | None = None):
    """Load an audio file, slice ``[offset, offset+duration]``, downmix to
    mono, resample to ``sr``.  Returns ``(y, sr)`` with ``y`` float32 in
    [-1, 1].

    Equivalent of ``librosa.load`` (reference ``utils.py:13`` accepts any
    audioread-decodable format).  Decode ladder, mirroring the video
    layer's backend ladder (``media/video.py``):

    1. WAV via scipy (always available, no subprocess);
    2. any other format (mp3/m4a/ogg/flac/...) via an ``ffmpeg``
       subprocess decoding straight to raw float32 PCM when a binary is
       on PATH;
    3. AIFF via the stdlib as a last resort;
    4. otherwise a clear error naming the options.
    """
    path = str(path)
    if not _looks_like_wav(path):
        return _load_audio_ffmpeg(path, sr, offset, duration)
    native_sr, data = wavfile.read(path)
    if data.dtype == np.int16:
        y = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        y = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        y = (data.astype(np.float32) - 128.0) / 128.0
    else:
        y = data.astype(np.float32)
    if y.ndim == 2:
        y = y.mean(axis=1)
    start = int(round(offset * native_sr))
    if duration is not None:
        y = y[start:start + int(round(duration * native_sr))]
    else:
        y = y[start:]
    if native_sr != sr:
        g = np.gcd(int(sr), int(native_sr))
        y = _sig.resample_poly(y, sr // g, native_sr // g)
    return y.astype(np.float32), sr


def _looks_like_wav(path: str) -> bool:
    """RIFF/WAVE magic sniff (extension-agnostic, like librosa)."""
    try:
        with open(path, "rb") as f:
            head = f.read(12)
        return head[:4] == b"RIFF" and head[8:12] == b"WAVE"
    except OSError:
        return False


def _load_audio_ffmpeg(path: str, sr: int, offset: float,
                       duration: float | None):
    """Non-WAV decode: ffmpeg subprocess -> raw f32le PCM on stdout.

    ffmpeg does the demux/decode/resample/downmix in one pass (same
    process-pipe pattern as the video layer's encoder,
    ``media/video.py``).  Slicing uses OUTPUT-side ``-ss``/``-t``:
    sample-accurate (input-side seeking lands on codec frame boundaries,
    ~26 ms on mp3 — enough to smear beat alignment) at the cost of
    decoding from the file start — trivial CPU for song-length inputs.
    """
    import shutil as _shutil
    import subprocess

    if not os.path.exists(path):
        raise FileNotFoundError(path)
    ffmpeg = _shutil.which("ffmpeg")
    if ffmpeg is None:
        if path.lower().endswith((".aif", ".aiff", ".aifc")):
            return _load_audio_aiff(path, sr, offset, duration)
        raise RuntimeError(
            f"{path!r} is not a WAV file and no `ffmpeg` binary is on PATH "
            "to decode it. Install ffmpeg, or convert the file to WAV "
            "(e.g. `ffmpeg -i song.mp3 song.wav`) on a machine that has it.")
    cmd = [ffmpeg, "-v", "error", "-i", path]
    if offset:
        cmd += ["-ss", f"{offset:.6f}"]
    if duration is not None:
        cmd += ["-t", f"{duration:.6f}"]
    cmd += ["-f", "f32le", "-acodec", "pcm_f32le", "-ar", str(int(sr)),
            "-ac", "1", "-"]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                          stderr=subprocess.PIPE)
    if proc.returncode != 0 or not proc.stdout:
        raise RuntimeError(
            f"ffmpeg failed to decode {path!r}: "
            f"{proc.stderr.decode(errors='replace').strip()}")
    return np.frombuffer(proc.stdout, np.float32).copy(), sr


def _load_audio_aiff(path: str, sr: int, offset: float,
                     duration: float | None):
    """Stdlib AIFF decode (big-endian PCM) for ffmpeg-less environments."""
    import warnings
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        import aifc
    with aifc.open(path, "rb") as f:
        native_sr = f.getframerate()
        n_ch = f.getnchannels()
        width = f.getsampwidth()
        raw = f.readframes(f.getnframes())
    dt = {1: np.int8, 2: np.dtype(">i2"), 4: np.dtype(">i4")}.get(width)
    if dt is None:
        raise RuntimeError(f"unsupported AIFF sample width {width}")
    y = np.frombuffer(raw, dt).astype(np.float32)
    y /= float(2 ** (8 * width - 1))
    if n_ch > 1:
        y = y.reshape(-1, n_ch).mean(axis=1)
    start = int(round(offset * native_sr))
    if duration is not None:
        y = y[start:start + int(round(duration * native_sr))]
    else:
        y = y[start:]
    if native_sr != sr:
        g = np.gcd(int(sr), int(native_sr))
        y = _sig.resample_poly(y, sr // g, native_sr // g)
    return np.ascontiguousarray(y, np.float32), sr


def save_wav(path, y: np.ndarray, sr: int = DEFAULT_SR):
    """Write mono float [-1,1] audio to 16-bit WAV (for muxing)."""
    y16 = np.clip(y, -1.0, 1.0)
    y16 = (y16 * 32767.0).astype(np.int16)
    wavfile.write(str(path), sr, y16)


# ---------------------------------------------------------------------------
# STFT / iSTFT (librosa-compatible: hann, centered, constant pad)
# ---------------------------------------------------------------------------

N_FFT = 2048          # STFT frame and Hann window
HOP = N_FFT // 4      # STFT hop
HPSS_KERNEL = 31      # median-filter length of the HPSS references
N_MELS = 128          # mel bands


def _hann(n: int) -> np.ndarray:
    return _sig.get_window("hann", n, fftbins=True).astype(np.float32)


def stft(y: np.ndarray) -> np.ndarray:
    """Short-time Fourier transform, shape ``(1 + N_FFT//2, frames)``."""
    win = _hann(N_FFT)
    ypad = np.pad(y, (N_FFT // 2, N_FFT // 2))
    n_frames = 1 + (len(ypad) - N_FFT) // HOP
    idx = np.arange(N_FFT)[None, :] + HOP * np.arange(n_frames)[:, None]
    frames = ypad[idx] * win[None, :]
    return np.fft.rfft(frames, n=N_FFT, axis=1).T


def istft(D: np.ndarray, length: int) -> np.ndarray:
    """Inverse STFT via windowed overlap-add with squared-window
    normalisation, cut or zero-padded to ``length`` samples."""
    win = _hann(N_FFT)
    frames = np.fft.irfft(D.T, n=N_FFT, axis=1)
    n_frames = frames.shape[0]
    out_len = N_FFT + HOP * (n_frames - 1)
    y = np.zeros(out_len, dtype=np.float64)
    wsum = np.zeros(out_len, dtype=np.float64)
    for i in range(n_frames):
        s = i * HOP
        y[s:s + N_FFT] += frames[i] * win
        wsum[s:s + N_FFT] += win ** 2
    y = y / np.maximum(wsum, 1e-10)
    y = y[N_FFT // 2:]
    y = y[:length] if len(y) >= length else np.pad(y, (0, length - len(y)))
    return y.astype(np.float32)


# ---------------------------------------------------------------------------
# HPSS (harmonic/percussive separation via median-filter soft masking)
# ---------------------------------------------------------------------------

def hpss(D: np.ndarray, margin: float = 1.0):
    """Split a complex spectrogram into (harmonic, percussive) parts.

    Median-filter the magnitude along time for the harmonic reference and
    along frequency for the percussive reference, then soft-mask with power
    2 (``librosa.decompose.hpss`` semantics; ``margin`` scales the competing
    reference as in the reference call ``utils.py:23``).
    """
    S = np.abs(D)
    harm = median_filter(S, size=(1, HPSS_KERNEL), mode="reflect")
    perc = median_filter(S, size=(HPSS_KERNEL, 1), mode="reflect")

    def softmask(x, x_ref):
        z = np.maximum(x, x_ref)
        z = np.where(z < 1e-10, 1.0, z)
        xs = (x / z) ** 2.0
        rs = (x_ref / z) ** 2.0
        return xs / (xs + rs + 1e-30)

    mask_h = softmask(harm, perc * margin)
    mask_p = softmask(perc, harm * margin)
    return D * mask_h, D * mask_p


# ---------------------------------------------------------------------------
# Mel spectrogram (slaney scale + slaney norm, librosa defaults)
# ---------------------------------------------------------------------------

def _hz_to_mel(f):
    f = np.asarray(f, dtype=np.float64)
    f_sp = 200.0 / 3
    mel = f / f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(f >= min_log_hz,
                    min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep,
                    mel)


def _mel_to_hz(m):
    m = np.asarray(m, dtype=np.float64)
    f_sp = 200.0 / 3
    freqs = f_sp * m
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(m >= min_log_mel,
                    min_log_hz * np.exp(logstep * (m - min_log_mel)),
                    freqs)


def mel_filterbank(sr: int) -> np.ndarray:
    """Slaney-style mel filterbank from 0 Hz to ``sr/2``, shape
    ``(N_MELS, 1 + N_FFT//2)``."""
    fft_freqs = np.linspace(0, sr / 2.0, 1 + N_FFT // 2)
    mel_pts = _mel_to_hz(np.linspace(_hz_to_mel(0.0), _hz_to_mel(sr / 2.0),
                                     N_MELS + 2))
    fdiff = np.diff(mel_pts)
    ramps = mel_pts[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    # slaney normalisation: equal area per band
    enorm = 2.0 / (mel_pts[2:N_MELS + 2] - mel_pts[:N_MELS])
    weights *= enorm[:, None]
    return weights.astype(np.float32)


def melspectrogram(y: np.ndarray, sr: int = DEFAULT_SR) -> np.ndarray:
    """Mel power spectrogram, shape ``(N_MELS, frames)``."""
    return mel_filterbank(sr) @ np.abs(stft(y)) ** 2.0


# ---------------------------------------------------------------------------
# The product: audio -> interpolation schedule
# ---------------------------------------------------------------------------

def get_timesteps_arr(audio_filepath, offset: float, duration: float,
                      fps: int = 30, margin: float = 1.0,
                      smooth: float = 0.0) -> np.ndarray:
    """Percussive-onset-driven interpolation schedule in [0, 1].

    Drop-in equivalent of the reference ``get_timesteps_arr``
    (``utils.py:12-39``): monotone non-decreasing, length ``duration*fps``,
    first value ~0, last value 1. ``smooth=1`` degenerates to pure linspace.
    """
    y, sr = load_audio(audio_filepath, sr=DEFAULT_SR, offset=offset,
                       duration=duration)
    _, D_perc = hpss(stft(y), margin=margin)
    y_perc = istft(D_perc, length=len(y))

    spec_raw = melspectrogram(y_perc, sr=sr)
    spec_max = np.amax(spec_raw, axis=0)
    ptp = np.ptp(spec_max)
    spec_norm = (spec_max - np.min(spec_max)) / (ptp if ptp > 0 else 1.0)

    x_norm = np.linspace(0, spec_norm.shape[-1], spec_norm.shape[-1])
    y_norm = np.cumsum(spec_norm)
    y_norm /= max(y_norm[-1], 1e-10)
    x_resize = np.linspace(0, y_norm.shape[-1], int(duration * fps))

    T = np.interp(x_resize, x_norm, y_norm)
    return T * (1 - smooth) + np.linspace(0.0, 1.0, T.shape[0]) * smooth
