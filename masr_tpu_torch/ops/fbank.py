"""Kaldi-compatible feature extraction: fbank / mfcc / linear spectrogram
on the host (the numpy half of masr_tpu/ops/fbank.py:25-190, copied), and
`fbank_torch`, the batched device fbank of the streaming frontend (port of
`fbank_jax`, masr_tpu/ops/fbank.py:199-251).

Kaldi spec: snip-edges framing, optional dither, DC-offset removal, 0.97
pre-emphasis (replicated first sample), povey window (hann**0.85),
round-to-pow2 FFT, power spectrum, Kaldi mel banks (low=20 Hz,
high=Nyquist), log with float32-eps floor. fbank and mfcc take waveforms at
**int16 scale** (the reference multiplies float samples by 2**15).
"""
import functools
import math

import numpy as np
import torch

EPSILON = 1.1920928955078125e-07  # float32 machine eps — Kaldi's log floor
MEL_HIGH = 1127.0
MEL_BREAK = 700.0


# --------------------------------------------------------------------------- #
# shared: window / mel-bank construction (host, cached)
# --------------------------------------------------------------------------- #
def next_pow2(n: int) -> int:
    return 1 if n == 0 else 2 ** (int(n) - 1).bit_length()


@functools.lru_cache(maxsize=None)
def povey_window(window_size: int) -> np.ndarray:
    n = np.arange(window_size, dtype=np.float64)
    hann = 0.5 - 0.5 * np.cos(2.0 * np.pi * n / (window_size - 1))
    return (hann ** 0.85).astype(np.float32)


def mel_scale(freq):
    return MEL_HIGH * np.log(1.0 + freq / MEL_BREAK)


@functools.lru_cache(maxsize=None)
def mel_banks(num_bins: int, padded_window_size: int, sample_rate: float,
              low_freq: float = 20.0, high_freq: float = 0.0) -> np.ndarray:
    """Kaldi mel filterbank matrix of shape (num_bins, padded_window_size//2+1).

    The last FFT bin (Nyquist) column is zero, matching Kaldi which computes
    banks over num_fft_bins = padded_window_size//2 bins.
    """
    assert num_bins >= 3
    num_fft_bins = padded_window_size // 2
    nyquist = 0.5 * sample_rate
    if high_freq <= 0.0:
        high_freq = nyquist + high_freq
    assert 0.0 <= low_freq < nyquist and low_freq < high_freq <= nyquist
    fft_bin_width = sample_rate / padded_window_size
    mel_low = mel_scale(low_freq)
    mel_high = mel_scale(high_freq)
    mel_delta = (mel_high - mel_low) / (num_bins + 1)

    bin_idx = np.arange(num_bins, dtype=np.float64)[:, None]
    left_mel = mel_low + bin_idx * mel_delta
    center_mel = mel_low + (bin_idx + 1.0) * mel_delta
    right_mel = mel_low + (bin_idx + 2.0) * mel_delta

    freqs = fft_bin_width * np.arange(num_fft_bins, dtype=np.float64)[None, :]
    mel = mel_scale(freqs)
    up_slope = (mel - left_mel) / (center_mel - left_mel)
    down_slope = (right_mel - mel) / (right_mel - center_mel)
    banks = np.maximum(0.0, np.minimum(up_slope, down_slope))
    # zero Nyquist column so the matrix multiplies the full rfft spectrum
    banks = np.concatenate([banks, np.zeros((num_bins, 1))], axis=1)
    return banks.astype(np.float32)


@functools.lru_cache(maxsize=None)
def dct_matrix(num_ceps: int, num_mel_bins: int) -> np.ndarray:
    """Orthonormal DCT-II matrix rows 0..num_ceps-1, shape (num_mel_bins, num_ceps)."""
    n = np.arange(num_mel_bins, dtype=np.float64)
    k = np.arange(num_ceps, dtype=np.float64)[:, None]
    dct = np.cos(np.pi / num_mel_bins * (n[None, :] + 0.5) * k)
    dct[0] *= math.sqrt(1.0 / num_mel_bins)
    dct[1:] *= math.sqrt(2.0 / num_mel_bins)
    return dct.T.astype(np.float32)  # (num_mel_bins, num_ceps)


@functools.lru_cache(maxsize=None)
def lifter_coeffs(num_ceps: int, cepstral_lifter: float = 22.0) -> np.ndarray:
    i = np.arange(num_ceps, dtype=np.float64)
    return (1.0 + 0.5 * cepstral_lifter * np.sin(np.pi * i / cepstral_lifter)).astype(np.float32)


def num_frames(num_samples: int, sample_rate: int = 16000,
               frame_length_ms: float = 25.0, frame_shift_ms: float = 10.0) -> int:
    """Kaldi snip_edges frame count."""
    window_size = int(sample_rate * frame_length_ms * 0.001)
    window_shift = int(sample_rate * frame_shift_ms * 0.001)
    if num_samples < window_size:
        return 0
    return 1 + (num_samples - window_size) // window_shift


# --------------------------------------------------------------------------- #
# numpy host path
# --------------------------------------------------------------------------- #
def _frame_signal_numpy(waveform, window_size, window_shift):
    m = (0 if len(waveform) < window_size
         else 1 + (len(waveform) - window_size) // window_shift)
    if m == 0:
        return np.zeros((0, window_size), dtype=np.float32)
    idx = np.arange(window_size)[None, :] + window_shift * np.arange(m)[:, None]
    return waveform[idx].astype(np.float32)


def _preprocess_frames_numpy(frames, dither, remove_dc_offset, preemph, window):
    # float32 throughout — matches torchaudio's float32 pipeline, so host
    # (numpy) and device (JAX) features agree to float32 rounding
    frames = frames.astype(np.float32)
    if dither != 0.0:
        frames = frames + dither * np.random.standard_normal(frames.shape).astype(np.float32)
    if remove_dc_offset:
        frames = frames - frames.mean(axis=1, keepdims=True, dtype=np.float32)
    if preemph != 0.0:
        prev = np.concatenate([frames[:, :1], frames[:, :-1]], axis=1)
        frames = frames - np.float32(preemph) * prev
    return frames * window


def fbank_numpy(waveform: np.ndarray, num_mel_bins: int = 80,
                frame_length_ms: float = 25.0, frame_shift_ms: float = 10.0,
                sample_rate: int = 16000, dither: float = 0.0,
                preemphasis: float = 0.97, remove_dc_offset: bool = True,
                low_freq: float = 20.0, high_freq: float = 0.0) -> np.ndarray:
    """Log-mel fbank features, (T, num_mel_bins) float32. Input at int16 scale."""
    window_size = int(sample_rate * frame_length_ms * 0.001)
    window_shift = int(sample_rate * frame_shift_ms * 0.001)
    padded = next_pow2(window_size)
    frames = _frame_signal_numpy(np.asarray(waveform), window_size, window_shift)
    if frames.shape[0] == 0:
        return np.zeros((0, num_mel_bins), dtype=np.float32)
    frames = _preprocess_frames_numpy(frames, dither, remove_dc_offset,
                                      preemphasis, povey_window(window_size))
    frames = np.pad(frames, ((0, 0), (0, padded - window_size))).astype(np.float32)
    spectrum = (np.abs(np.fft.rfft(frames, axis=1)) ** 2).astype(np.float32)
    banks = mel_banks(num_mel_bins, padded, float(sample_rate), low_freq, high_freq)
    mel = spectrum @ banks.T
    return np.log(np.maximum(mel, EPSILON)).astype(np.float32)


def mfcc_numpy(waveform: np.ndarray, num_mel_bins: int = 80, num_ceps: int = 40,
               frame_length_ms: float = 25.0, frame_shift_ms: float = 10.0,
               sample_rate: int = 16000, dither: float = 0.0,
               cepstral_lifter: float = 22.0) -> np.ndarray:
    """MFCC features, (T, num_ceps) float32 (Kaldi-compatible, no energy)."""
    mel = fbank_numpy(waveform, num_mel_bins, frame_length_ms, frame_shift_ms,
                      sample_rate, dither)
    feats = mel @ dct_matrix(num_ceps, num_mel_bins)
    if cepstral_lifter != 0.0:
        feats = feats * lifter_coeffs(num_ceps, cepstral_lifter)[None, :]
    return feats.astype(np.float32)


def linear_numpy(samples: np.ndarray, sample_rate: int = 16000,
                 frame_shift_ms: float = 10.0, frame_length_ms: float = 20.0,
                 eps: float = 1e-14) -> np.ndarray:
    """Hand-rolled log-power linear spectrogram, (T, 161) at 16 kHz
    (parity: audio_featurizer.py:72-94 — hanning window, PSD scaling).
    Input is float samples in [-1, 1] (NOT int16-scaled)."""
    stride_size = int(0.001 * sample_rate * frame_shift_ms)
    window_size = int(0.001 * sample_rate * frame_length_ms)
    samples = np.asarray(samples)
    truncate_size = (len(samples) - window_size) % stride_size
    samples = samples[:len(samples) - truncate_size]
    m = (len(samples) - window_size) // stride_size + 1
    idx = np.arange(window_size)[None, :] + stride_size * np.arange(m)[:, None]
    windows = samples[idx]  # (T, window)
    weighting = np.hanning(window_size)
    fft = np.abs(np.fft.rfft(windows * weighting[None, :], axis=1)) ** 2
    scale = np.sum(weighting ** 2) * sample_rate
    fft[:, 1:-1] *= 2.0 / scale
    fft[:, (0, -1)] /= scale
    freqs = float(sample_rate) / window_size * np.arange(fft.shape[1])
    ind = np.where(freqs <= (sample_rate / 2))[0][-1] + 1
    return np.log(fft[:, :ind] + eps).astype(np.float32)


# --------------------------------------------------------------------------- #
# torch path (batched, length-masked, on the waveform's device)
# --------------------------------------------------------------------------- #
def fbank_torch(waveform: torch.Tensor, lengths=None, *,
                num_mel_bins: int = 80, frame_length_ms: float = 25.0,
                frame_shift_ms: float = 10.0, sample_rate: int = 16000,
                dither: float = 0.0, generator=None,
                preemphasis: float = 0.97, remove_dc_offset: bool = True):
    """Batched Kaldi fbank on the device of `waveform`.

    waveform: (B, S) float32 at int16 scale, zero-padded to S; lengths:
    (B,) valid sample counts, or None for full length; dither > 0 draws
    its noise from `generator`. → (feats (B, T, num_mel_bins) float32 with
    frames past the valid length zeroed, feat_lengths (B,) int32)."""
    if waveform.dim() == 1:
        waveform = waveform[None]
    B, S = waveform.shape
    dev = waveform.device
    window_size = int(sample_rate * frame_length_ms * 0.001)
    window_shift = int(sample_rate * frame_shift_ms * 0.001)
    padded = next_pow2(window_size)
    T = 0 if S < window_size else 1 + (S - window_size) // window_shift
    if lengths is None:
        lengths = torch.full((B,), S, dtype=torch.int32, device=dev)
    lengths = torch.as_tensor(lengths, device=dev)

    if T == 0:
        frames = waveform.new_zeros((B, 0, window_size), dtype=torch.float32)
    else:
        frames = waveform.float().unfold(1, window_size, window_shift)
    if dither != 0.0:
        frames = frames + dither * torch.randn(
            frames.shape, generator=generator, device=dev)
    if remove_dc_offset:
        frames = frames - frames.mean(dim=-1, keepdim=True)
    if preemphasis != 0.0:
        prev = torch.cat([frames[..., :1], frames[..., :-1]], dim=-1)
        frames = frames - preemphasis * prev
    frames = frames * torch.from_numpy(povey_window(window_size)).to(dev)
    frames = torch.nn.functional.pad(frames, (0, padded - window_size))

    spectrum = torch.fft.rfft(frames, dim=-1).abs() ** 2
    banks = torch.from_numpy(mel_banks(num_mel_bins, padded,
                                       float(sample_rate))).to(dev)
    feats = torch.log(torch.clamp(spectrum @ banks.t(), min=EPSILON))

    feat_lengths = torch.where(
        lengths < window_size, 0,
        1 + (lengths - window_size) // window_shift).to(torch.int32)
    mask = torch.arange(T, device=dev)[None, :] < feat_lengths[:, None]
    return torch.where(mask[..., None], feats, 0.0), feat_lengths
