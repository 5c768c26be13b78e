"""The port's host augmentation (masr_tpu_torch/data/augmentation), its
augmented dataset and its binary manifests (data/binary.py) against
masr_tpu's on the CPU.

Each augmentor and the pipeline over configs/augmentation.json (its noise
manifest pointed at synthetic noise clips) run in both packages from
random.Random(seed) instances of the same seed on copies of the same
audio or features (the noise's random subsegment draws from the global
`random` in both packages, AudioSegment.random_subsegment, so the test
seeds it alike before each call): the draws are the same, so the audio
and features are equal, within 1e-6 where a resampling runs (the speed
perturbation and the resampler go through the same numpy code in both
packages). The augmented
dataset's items: features within 1e-4 (fbank of equal audio in another
process order, as tests/test_torch_training.py holds the plain items to
1e-5, with the augmentors' rounding on top), token ids exactly. Binary
manifests: the files either package writes are byte-equal, and each
package's reader reads the other's.
"""
import json
import logging
import os
import random

import numpy as np
import pytest

from masr_tpu.audio import AudioSegment as JaxSegment
from masr_tpu.data.augmentation import augmentors as JA
from masr_tpu.data.augmentation.pipeline import \
    AugmentationPipeline as JaxPipeline
from masr_tpu_torch.audio import AudioSegment
from masr_tpu_torch.data.augmentation import augmentors as PA
from masr_tpu_torch.data.augmentation.pipeline import AugmentationPipeline
from test_torch_threads import one_torch_thread  # noqa: F401

CONFIG = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "configs", "augmentation.json")
SR = 16000


def _audio(seed, seconds=1.3):
    rs = np.random.RandomState(seed)
    t = np.arange(int(seconds * SR)) / SR
    return (0.3 * np.sin(2 * np.pi * (180 + 40 * seed) * t)
            + 0.05 * rs.standard_normal(len(t))).astype(np.float32)


@pytest.fixture(scope="module")
def noise_manifest(tmp_path_factory):
    """Three noise clips (one shorter than the utterances) and their JSONL
    manifest → the manifest's path."""
    from masr_tpu_torch.audio.io import write_wave
    root = tmp_path_factory.mktemp("noise")
    lines = []
    for i, seconds in enumerate((0.4, 2.0, 1.1)):
        rs = np.random.RandomState(50 + i)
        wav = (0.2 * rs.standard_normal(int(seconds * SR))).astype(
            np.float32)
        path = str(root / f"noise_{i}.wav")
        write_wave(path, wav, SR)
        lines.append(json.dumps({"audio_filepath": path,
                                 "duration": seconds, "text": ""}))
    manifest = root / "manifest.noise"
    manifest.write_text("\n".join(lines) + "\n")
    return str(manifest)


def _audio_case(kind, params, seed):
    """One audio augmentor in both packages from equal seeds, three times
    over the same utterances → (port samples, masr_tpu samples) lists."""
    port_aug = getattr(PA, kind)(random.Random(seed), **params)
    jax_aug = getattr(JA, kind)(random.Random(seed), **params)
    got, want = [], []
    for i in range(3):
        a, b = AudioSegment(_audio(i), SR), JaxSegment(_audio(i), SR)
        random.seed(i)
        port_aug.transform_audio(a)
        random.seed(i)
        jax_aug.transform_audio(b)
        got.append(a.samples)
        want.append(b.samples)
    return got, want


@pytest.mark.parametrize("kind,params,tol", [
    ("SpeedPerturbAugmentor", {}, 1e-6),
    ("SpeedPerturbAugmentor", {"num_rates": 0}, 1e-6),
    ("VolumePerturbAugmentor", {}, 0.0),
    ("ShiftPerturbAugmentor", {"min_shift_ms": -50, "max_shift_ms": 50},
     0.0),
    ("ResampleAugmentor", {}, 1e-6),
], ids=["speed", "speed_uniform", "volume", "shift", "resample"])
def test_audio_augmentors_match_masr_tpu(kind, params, tol):
    got, want = _audio_case(kind, params, 3)
    for g, w, i in zip(got, want, range(3)):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, atol=tol, rtol=0)
    assert any(g.shape != _audio(i).shape or not np.array_equal(g, _audio(i))
               for i, g in enumerate(got))


def test_noise_augmentor_matches_masr_tpu(noise_manifest):
    """1-2 clips at an SNR from [10, 50] dB, the short clip repeated."""
    got, want = _audio_case("NoisePerturbAugmentor",
                            {"noise_manifest_path": noise_manifest}, 5)
    for g, w, i in zip(got, want, range(3)):
        np.testing.assert_allclose(g, w, atol=1e-6, rtol=0)
        assert not np.array_equal(g, _audio(i))


def _features(seed, T=120, F=80):
    rs = np.random.RandomState(seed)
    return (10.0 + 3.0 * rs.standard_normal((T, F))).astype(np.float32)


@pytest.mark.parametrize("kind,params", [
    ("SpecAugmentor", {"F": 10, "T": 50, "n_freq_masks": 2,
                       "n_time_masks": 2, "p": 1.0}),
    ("SpecAugmentor", {"F": 10, "T": 50, "p": 0.1,
                       "replace_with_zero": True}),
    ("SpecAugmentor", {"use_time_warp": True, "max_time_warp": 5}),
    ("SpecSubAugmentor", {"max_t": 30, "num_t_sub": 3}),
], ids=["specaug", "specaug_zero", "specaug_warp", "specsub"])
def test_feature_augmentors_match_masr_tpu(kind, params):
    """SpecAugment (with the PIL time warp where PIL imports, else x
    unchanged by it, in both) and SpecSub: equal features."""
    port_aug = getattr(PA, kind)(random.Random(8), **params)
    jax_aug = getattr(JA, kind)(random.Random(8), **params)
    for i in range(4):
        x = _features(i)
        got = port_aug.transform_feature(x.copy())
        want = jax_aug.transform_feature(x.copy())
        np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got, _features(3))


def _config_with_noise(noise_manifest):
    with open(CONFIG, encoding="utf-8") as f:
        items = json.load(f)
    for item in items:
        if item["type"] == "noise":
            item["params"]["noise_manifest_path"] = noise_manifest
    return json.dumps(items)


def test_pipeline_over_augmentation_json_matches_masr_tpu(noise_manifest):
    """configs/augmentation.json (noise p 0.5, speed, shift, volume,
    SpecAugment, SpecSub) from one seed: the same audio (1e-6) and the
    same augmented features, utterance after utterance."""
    from masr_tpu.data.audio_featurizer import AudioFeaturizer as JFeat
    from masr_tpu_torch.data.audio_featurizer import AudioFeaturizer
    conf = _config_with_noise(noise_manifest)
    port, ref = (AugmentationPipeline(conf, seed=11),
                 JaxPipeline(conf, seed=11))
    assert [type(a).__name__ for a, _ in port._audio_augmentors] == \
        [type(a).__name__ for a, _ in ref._audio_augmentors] == \
        ["NoisePerturbAugmentor", "SpeedPerturbAugmentor",
         "ShiftPerturbAugmentor", "VolumePerturbAugmentor"]
    feat, jfeat = AudioFeaturizer(), JFeat()
    for i in range(4):
        a, b = AudioSegment(_audio(i), SR), JaxSegment(_audio(i), SR)
        random.seed(i)
        port.transform_audio(a)
        random.seed(i)
        ref.transform_audio(b)
        np.testing.assert_allclose(a.samples, b.samples, atol=1e-6, rtol=0)
        x = feat.featurize(a)
        np.testing.assert_allclose(x, jfeat.featurize(b), atol=1e-4,
                                   rtol=0)
        got = port.transform_feature(x.copy())
        want = ref.transform_feature(x.copy())
        np.testing.assert_array_equal(got, want)


def test_pipeline_drops_missing_noise_manifest(caplog):
    """A noise augmentor whose manifest is missing is dropped with masr_tpu's
    warning; disabled items (prob 0) build nothing; an unknown type
    raises."""
    logger = logging.getLogger("masr_tpu_torch")
    logger.addHandler(caplog.handler)      # the port's logger may not propagate
    try:
        pipe = AugmentationPipeline(CONFIG, seed=0)
    finally:
        logger.removeHandler(caplog.handler)
    assert "noise augmentor dropped" in caplog.text
    assert [type(a).__name__ for a, _ in pipe._audio_augmentors] == \
        ["SpeedPerturbAugmentor", "ShiftPerturbAugmentor",
         "VolumePerturbAugmentor"]
    assert len(pipe._feature_augmentors) == 2
    assert not AugmentationPipeline("{}")._audio_augmentors
    with pytest.raises(ValueError, match="unknown augmentor"):
        AugmentationPipeline(json.dumps([{"type": "echo", "prob": 1}]))


# --------------------------------------------------------------------------- #
# the dataset and binary manifests
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    from test_torch_training import _corpus
    return _corpus(str(tmp_path_factory.mktemp("corpus")), n_train=6,
                   n_test=2)


PRE = dict(feature_method="fbank", n_mels=80, sample_rate=16000,
           use_dB_normalization=True, target_dB=-20)


@pytest.mark.parametrize("waveform", [False, True],
                         ids=["features", "waveforms"])
def test_augmented_dataset_matches_masr_tpu(corpus, noise_manifest,
                                            waveform):
    """MASRDataset(train=True) over configs/augmentation.json from one seed:
    every item equal to masr_tpu's (features within 1e-4, or with
    return_waveform the augmented int16-scale samples within 1e-2 of one
    int16 step's 1: truncation may take the other side of an integer;
    ids exactly). Dither is on in training, so the test turns it off by
    featurizing in eval mode on both sides."""
    from masr_tpu.data.dataset import MASRDataset as JDataset
    from masr_tpu_torch.data.dataset import MASRDataset
    conf = _config_with_noise(noise_manifest)
    ours = MASRDataset(PRE, corpus["train"], corpus["vocab"],
                       augmentation_config=conf, train=True, seed=4,
                       return_waveform=waveform)
    theirs = JDataset(PRE, corpus["train"], corpus["vocab"],
                      augmentation_config=conf, train=True, seed=4,
                      return_waveform=waveform)
    for ds in (ours, theirs):
        ds._audio_featurizer._train = False
    for i in range(len(ours)):
        random.seed(i)
        f, ids = ours[i]
        random.seed(i)
        jf, jids = theirs[i]
        assert f.shape == jf.shape and f.dtype == np.float32
        if waveform:
            assert np.mean(f != jf) < 1e-3
            np.testing.assert_allclose(f, jf, atol=1.0 + 1e-2, rtol=0)
        else:
            np.testing.assert_allclose(f, jf, atol=1e-4, rtol=0)
        np.testing.assert_array_equal(ids, jids)


def test_binary_manifests_match_masr_tpu(corpus, tmp_path):
    """create_manifest_binary of either package writes the same .data and
    .header bytes; each package's DatasetReader reads the other's records,
    duration filter included; a binary-manifest dataset gives the JSONL
    one's items."""
    import shutil
    from masr_tpu.data.binary import DatasetReader as JReader
    from masr_tpu.data.binary import create_manifest_binary as jcreate
    from masr_tpu_torch.data.binary import (DatasetReader,
                                            create_manifest_binary)
    from masr_tpu_torch.data.dataset import MASRDataset
    dirs = {}
    for name, create in (("port", create_manifest_binary),
                         ("jax", jcreate)):
        d = tmp_path / name
        d.mkdir()
        for split in ("train", "test"):
            shutil.copy(corpus[split], d / f"manifest.{split}")
        create(str(d / "manifest.train"), str(d / "manifest.test"))
        dirs[name] = d
    for split in ("train", "test"):
        for ext in (".data", ".header"):
            f = f"manifest.{split}{ext}"
            assert (dirs["port"] / f).read_bytes() == \
                (dirs["jax"] / f).read_bytes(), f
    with open(corpus["train"], encoding="utf-8") as f:
        entries = [json.loads(l) for l in f if l.strip()]
    cut = sorted(e["duration"] for e in entries)[2]
    for reader, other in ((DatasetReader, "jax"), (JReader, "port")):
        r = reader(str(dirs[other] / "manifest.train.data"),
                   min_duration=cut)
        assert [r.get_data(i) for i in range(len(r))] == \
            [e for e in entries if e["duration"] >= cut]
        r.close()
    binary = MASRDataset(PRE, str(dirs["jax"] / "manifest.train.data"),
                         corpus["vocab"], manifest_type="binary")
    txt = MASRDataset(PRE, corpus["train"], corpus["vocab"])
    assert len(binary) == len(txt) == 6
    assert binary.durations == txt.durations
    for i in (0, 5):
        np.testing.assert_array_equal(binary[i][0], txt[i][0])
        np.testing.assert_array_equal(binary[i][1], txt[i][1])
