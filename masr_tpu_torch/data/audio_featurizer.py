"""Audio feature orchestration (port of masr_tpu/data/audio_featurizer.py:
13-77, the host path and the host half of the on-device frontend).

Per utterance: resample to the target rate → dB-normalize to target_dB →
fbank/mfcc at int16 scale | linear at float scale; `prepare_waveform` stops
before the features.
"""
import numpy as np

from masr_tpu_torch.ops import fbank as F


class AudioFeaturizer(object):
    def __init__(self, feature_method="fbank", n_mels=80, n_mfcc=40,
                 sample_rate=16000, use_dB_normalization=True, target_dB=-20,
                 train=False):
        self._feature_method = feature_method
        self._target_sample_rate = sample_rate
        self._n_mels = n_mels
        self._n_mfcc = n_mfcc
        self._use_dB_normalization = use_dB_normalization
        self._target_dB = target_dB
        self._train = train

    def featurize(self, audio_segment):
        """AudioSegment → (T, feature_dim) float32 ndarray."""
        if audio_segment.sample_rate != self._target_sample_rate:
            audio_segment.resample(self._target_sample_rate)
        if self._use_dB_normalization:
            audio_segment.normalize(target_db=self._target_dB)
        sr = audio_segment.sample_rate
        # train-time dither=1.0, eval dither=0 (audio_featurizer.py:104,127)
        dither = 1.0 if self._train else 0.0
        if self._feature_method == "linear":
            return F.linear_numpy(audio_segment.samples, sr)
        samples = audio_segment.to("int16").astype(np.float32)
        if self._feature_method == "mfcc":
            return F.mfcc_numpy(samples, num_mel_bins=self._n_mels,
                                num_ceps=self._n_mfcc, sample_rate=sr,
                                dither=dither)
        if self._feature_method == "fbank":
            return F.fbank_numpy(samples, num_mel_bins=self._n_mels,
                                 sample_rate=sr, dither=dither)
        raise ValueError(f"unknown feature_method: {self._feature_method}")

    def featurize_waveform(self, samples: np.ndarray, sample_rate: int):
        """Featurize a raw float waveform without an AudioSegment."""
        from masr_tpu_torch.audio import AudioSegment
        return self.featurize(AudioSegment(samples, sample_rate))

    def prepare_waveform(self, audio_segment):
        """The host half of the on-device frontend: resample, dB-normalize
        and scale to int16 (truncating), no features; fbank, dither and
        SpecAugment run on the device (ops/specaug.py). → float32 samples
        at int16 scale."""
        if self._feature_method not in ("fbank", "mfcc"):
            raise ValueError("on-device frontend supports fbank/mfcc only")
        if audio_segment.sample_rate != self._target_sample_rate:
            audio_segment.resample(self._target_sample_rate)
        if self._use_dB_normalization:
            audio_segment.normalize(target_db=self._target_dB)
        return audio_segment.to("int16").astype(np.float32)

    @property
    def feature_dim(self):
        if self._feature_method == "linear":
            return 161
        if self._feature_method == "mfcc":
            return self._n_mfcc
        if self._feature_method == "fbank":
            return self._n_mels
        raise ValueError(f"unknown feature_method: {self._feature_method}")

    @property
    def sample_rate(self):
        return self._target_sample_rate
