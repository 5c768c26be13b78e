"""MASRDataset (port of masr_tpu/data/dataset.py, host numpy code): a
map-style dataset over a JSONL manifest or a binary one (data/binary.py)
of audio files, whole or sliced by start_time / end_time, or of
precomputed feature slabs (start_frame / end_frame: rows of an .npy slab
that MASRTrainer.extract_features wrote, read through an mmap,
masr_tpu/data/dataset.py:64-69).

Per item, in masr_tpu's order (masr_tpu/data/dataset.py:71-86): the
audio augmentors (training only), then the fbank features (or the slab's
rows), then the feature augmentors → (features (T, F) float32, token ids
int32). With
return_waveform, the host half of the on-device frontend instead: the
augmented audio resampled, dB-normalized and at int16 scale, (samples
(S,) float32, token ids); fbank, SpecAugment and SpecSub then run on the
device (ops/specaug.py); a slab entry then raises ValueError (it has no
audio).
"""
import numpy as np

from masr_tpu_torch.audio import AudioSegment
from masr_tpu_torch.data.audio_featurizer import AudioFeaturizer
from masr_tpu_torch.data.augmentation import AugmentationPipeline
from masr_tpu_torch.data.manifest import read_manifest
from masr_tpu_torch.data.text_featurizer import TextFeaturizer


class MASRDataset(object):
    def __init__(self, preprocess_configs, data_manifest, vocab_filepath,
                 manifest_type="txt", min_duration=0.0, max_duration=20.0,
                 augmentation_config="{}", train=False, seed=None,
                 return_waveform=False):
        """augmentation_config: a path to an augmentation JSON, or its text
        (training only; seed seeds its random.Random); manifest_type "txt"
        (JSONL) or "binary" (data_manifest names the .data file)."""
        self.return_waveform = bool(return_waveform)
        self._audio_featurizer = AudioFeaturizer(train=train,
                                                 **dict(preprocess_configs))
        self._text_featurizer = TextFeaturizer(vocab_filepath) \
            if vocab_filepath else None
        self._augmentation_pipeline = AugmentationPipeline(
            augmentation_config=augmentation_config, seed=seed) \
            if train else None
        max_duration = float("inf") if max_duration == -1 else max_duration
        if manifest_type == "txt":
            self.entries = read_manifest(data_manifest,
                                         min_duration=min_duration,
                                         max_duration=max_duration)
            self._reader = None
        elif manifest_type == "binary":
            from masr_tpu_torch.data.binary import DatasetReader
            self._reader = DatasetReader(data_manifest,
                                         min_duration=min_duration,
                                         max_duration=max_duration)
            self.entries = None
        else:
            raise ValueError(f"unknown manifest_type: {manifest_type}")

    def _entry(self, idx):
        if self.entries is not None:
            return self.entries[idx]
        return self._reader.get_data(idx)

    def __len__(self):
        return len(self.entries) if self.entries is not None \
            else len(self._reader)

    def __getitem__(self, idx):
        """→ (features (T, F) float32, token ids int32); with
        return_waveform (samples (S,) float32 at int16 scale, token ids)."""
        entry = self._entry(idx)
        if "start_frame" in entry:
            if self.return_waveform:
                raise ValueError("on-device frontend cannot consume "
                                 "precomputed feature manifests")
            slab = np.load(entry["audio_filepath"], mmap_mode="r")
            feature = np.array(slab[entry["start_frame"]:entry["end_frame"]],
                               dtype=np.float32)
        else:
            if "start_time" in entry:
                segment = AudioSegment.slice_from_file(
                    entry["audio_filepath"], entry["start_time"],
                    entry["end_time"])
            else:
                segment = AudioSegment.from_file(entry["audio_filepath"])
            if self._augmentation_pipeline is not None:
                self._augmentation_pipeline.transform_audio(segment)
            if self.return_waveform:
                feature = self._audio_featurizer.prepare_waveform(segment)
            else:
                feature = self._audio_featurizer.featurize(segment)
        if self._augmentation_pipeline is not None \
                and not self.return_waveform:
            feature = self._augmentation_pipeline.transform_feature(feature)
        ids = np.asarray(self._text_featurizer.featurize(entry["text"])
                         if self._text_featurizer else [], dtype=np.int32)
        return feature, ids

    @property
    def durations(self):
        return [self._entry(i)["duration"] for i in range(len(self))]

    @property
    def feature_dim(self):
        return self._audio_featurizer.feature_dim

    @property
    def vocab_size(self):
        return self._text_featurizer.vocab_size

    @property
    def vocab_list(self):
        return self._text_featurizer.vocab_list
