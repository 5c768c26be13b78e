"""Audio- and feature-domain augmentors (port of
masr_tpu/data/augmentation/augmentors.py, host numpy code).

Audio augmentors change an AudioSegment in place; feature augmentors
return a new (T, F) ndarray. Every augmentor draws from the random.Random
its pipeline hands it, in masr_tpu's order, so that one seed gives
masr_tpu's draws and outputs.
"""
import logging

import numpy as np

from masr_tpu_torch.audio import AudioSegment
from masr_tpu_torch.data.manifest import read_manifest

logger = logging.getLogger("masr_tpu_torch")


class AugmentorBase(object):
    def transform_audio(self, audio_segment):
        raise NotImplementedError

    def transform_feature(self, feature):
        raise NotImplementedError


class NoisePerturbAugmentor(AugmentorBase):
    """Mix 1..repetition noise clips from the noise manifest, each at an
    SNR drawn from [min_snr_dB, max_snr_dB]; a noise shorter than the
    utterance is repeated to cover it."""

    def __init__(self, rng, min_snr_dB=10, max_snr_dB=50, repetition=2,
                 noise_manifest_path=None):
        self._rng = rng
        self._min_snr_dB = min_snr_dB
        self._max_snr_dB = max_snr_dB
        self._repetition = repetition
        self._noise_manifest = read_manifest(noise_manifest_path) \
            if noise_manifest_path else []

    def transform_audio(self, audio_segment):
        if len(self._noise_manifest) == 0:
            return
        for _ in range(self._rng.randint(1, self._repetition)):
            entry = self._rng.choice(self._noise_manifest)
            snr_dB = self._rng.uniform(self._min_snr_dB, self._max_snr_dB)
            noise = AudioSegment.from_file(entry["audio_filepath"])
            if noise.sample_rate != audio_segment.sample_rate:
                noise.resample(audio_segment.sample_rate)
            if noise.duration < audio_segment.duration:
                reps = int(np.ceil(audio_segment.duration / noise.duration))
                noise = AudioSegment.concatenate(*([noise] * reps))
            audio_segment.add_noise(noise, snr_dB)


class SpeedPerturbAugmentor(AugmentorBase):
    """One of num_rates speed rates evenly spaced over [min, max] (a uniform
    rate when num_rates is 0); rates outside [0.9, 1.1] are refused."""

    def __init__(self, rng, min_speed_rate=0.9, max_speed_rate=1.1,
                 num_rates=3):
        if min_speed_rate < 0.9 or max_speed_rate > 1.1:
            raise ValueError("speed rates outside [0.9, 1.1] distort audio "
                             "badly")
        self._rng = rng
        self._rates = np.linspace(min_speed_rate, max_speed_rate, num_rates,
                                  endpoint=True) if num_rates > 0 else None
        self._min, self._max = min_speed_rate, max_speed_rate

    def transform_audio(self, audio_segment):
        if self._rates is None:
            rate = self._rng.uniform(self._min, self._max)
        else:
            rate = self._rates[self._rng.randint(0, len(self._rates) - 1)]
        audio_segment.change_speed(rate)


class VolumePerturbAugmentor(AugmentorBase):
    """A gain drawn from [min_gain_dBFS, max_gain_dBFS]."""

    def __init__(self, rng, min_gain_dBFS=-15, max_gain_dBFS=15):
        self._rng = rng
        self._min, self._max = min_gain_dBFS, max_gain_dBFS

    def transform_audio(self, audio_segment):
        audio_segment.gain_db(self._rng.uniform(self._min, self._max))


class ShiftPerturbAugmentor(AugmentorBase):
    """A time shift drawn from [min_shift_ms, max_shift_ms]."""

    def __init__(self, rng, min_shift_ms=-5, max_shift_ms=5):
        self._rng = rng
        self._min, self._max = min_shift_ms, max_shift_ms

    def transform_audio(self, audio_segment):
        audio_segment.shift(self._rng.uniform(self._min, self._max))


class ResampleAugmentor(AugmentorBase):
    """Resample to one of new_sample_rate."""

    def __init__(self, rng, new_sample_rate=(8000, 32000, 44100, 48000)):
        self._rng = rng
        self._rates = list(new_sample_rate)

    def transform_audio(self, audio_segment):
        audio_segment.resample(self._rng.choice(self._rates))


class SpecAugmentor(AugmentorBase):
    """SpecAugment: an optional PIL bicubic time warp of ±max_time_warp
    frames (x unchanged when PIL is absent), then n_freq_masks frequency
    masks of width < min(F, n_freq) and n_time_masks time masks of width
    < min(T, p·frames), filled with the feature mean (or 0)."""

    def __init__(self, rng, F=10, T=50, n_freq_masks=2, n_time_masks=2,
                 p=1.0, W=80, inplace=True, replace_with_zero=False,
                 max_time_warp=5, use_time_warp=False):
        self._rng = rng
        self.F = F
        self.T = T
        self.n_freq_masks = n_freq_masks
        self.n_time_masks = n_time_masks
        self.p = p
        self.W = max_time_warp
        self.use_time_warp = use_time_warp
        self.replace_with_zero = replace_with_zero

    def _time_warp(self, x):
        """Stretch [0, center) and [center, T) by ±W frames (PIL bicubic)."""
        try:
            from PIL import Image
        except ImportError:
            return x
        window = self.W
        t = x.shape[0]
        if t - window <= window:
            return x
        center = self._rng.randint(window, t - window)
        warped = self._rng.randint(center - window, center + window) + 1
        f = x.shape[1]
        left = Image.fromarray(x[:center]).resize((f, warped), Image.BICUBIC)
        right = Image.fromarray(x[center:]).resize((f, t - warped),
                                                   Image.BICUBIC)
        return np.concatenate([np.asarray(left), np.asarray(right)], axis=0)

    def transform_feature(self, x):
        x = np.asarray(x, dtype=np.float32)
        if self.use_time_warp:
            x = self._time_warp(x)
        t_len, n_freq = x.shape
        fill = 0.0 if self.replace_with_zero else float(x.mean())
        max_f = min(self.F, n_freq)
        for _ in range(self.n_freq_masks):
            f = self._rng.randint(0, max_f)
            f0 = self._rng.randint(0, n_freq - f) if n_freq - f > 0 else 0
            x[:, f0:f0 + f] = fill
        max_t = min(self.T, max(int(self.p * t_len), 1))
        for _ in range(self.n_time_masks):
            t = self._rng.randint(0, max_t)
            t0 = self._rng.randint(0, t_len - t) if t_len - t > 0 else 0
            x[t0:t0 + t, :] = fill
        return x


class SpecSubAugmentor(AugmentorBase):
    """SpecSub: num_t_sub times, a span of < max_t frames is overwritten by
    the original frames `pos` earlier."""

    def __init__(self, rng, max_t=20, num_t_sub=3):
        self._rng = rng
        self.max_t = max_t
        self.num_t_sub = num_t_sub

    def transform_feature(self, x):
        x = np.asarray(x, dtype=np.float32)
        y = x.copy()
        t_len = x.shape[0]
        for _ in range(self.num_t_sub):
            t = self._rng.randint(0, self.max_t)
            if t_len - t <= 0:
                continue
            start = self._rng.randint(0, t_len - t)
            end = start + t
            pos = self._rng.randint(0, max(start, 1)) if start > 0 else 0
            y[start:end, :] = x[start - pos:end - pos, :]
        return y
