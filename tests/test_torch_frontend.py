"""The port's host frontend (masr_tpu_torch/ops/fbank.py,
data/audio_featurizer.py) against masr_tpu's numpy kernels and the frozen
goldens (tests/goldens/fbank_goldens.npz, from an independent float64
oracle; tolerances as tests/test_fbank_goldens.py states them)."""
import os

import numpy as np
import pytest

from masr_tpu.audio import AudioSegment as FlaxSegment
from masr_tpu.data.audio_featurizer import AudioFeaturizer as JaxFeaturizer
from masr_tpu.ops import fbank as jf
from masr_tpu_torch.audio import AudioSegment
from masr_tpu_torch.data.audio_featurizer import AudioFeaturizer
from masr_tpu_torch.ops import fbank as tf
from test_torch_threads import one_torch_thread  # noqa: F401

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens",
                       "fbank_goldens.npz")


@pytest.mark.parametrize("name", ["fbank_numpy", "mfcc_numpy",
                                  "linear_numpy"])
def test_host_features_equal_masr_tpu(name):
    """Same numpy code on the same random audio: bit-equal."""
    rs = np.random.RandomState(3)
    wav = rs.uniform(-2e4, 2e4, 12345).astype(np.float32)
    if name == "linear_numpy":
        wav = wav / 32768.0
    np.testing.assert_array_equal(getattr(tf, name)(wav),
                                  getattr(jf, name)(wav))


@pytest.mark.parametrize("name", ["noise", "tone", "chirp"])
def test_fbank_matches_golden(name):
    g = np.load(GOLDENS)
    got = tf.fbank_numpy(g[f"wave_{name}"], num_mel_bins=80,
                         sample_rate=16000)
    want = g[f"fbank_{name}"]
    d = np.abs(got - want)
    assert d[want > want.max() - 8.0].max() < 1e-5
    if name == "noise":                      # broadband: all bins tight
        np.testing.assert_allclose(got, want, atol=1e-4)
    else:                                    # narrowband quiet-bin noise
        assert np.percentile(d, 99) < 0.05
        assert d.max() < 0.5


def test_featurizer_equals_masr_tpu():
    """dB normalisation + int16 scaling + fbank: bit-equal features."""
    from masr_tpu_torch.audio.synth_tts import SyntheticTTS
    wav = SyntheticTTS().render("你好世界", spk_id=1)
    got = AudioFeaturizer().featurize(AudioSegment(wav, 16000))
    want = JaxFeaturizer().featurize(FlaxSegment(wav, 16000))
    np.testing.assert_array_equal(got, want)
