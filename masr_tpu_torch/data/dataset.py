"""MASRDataset (port of masr_tpu/data/dataset.py:20, host numpy code):
a map-style dataset over a JSONL manifest of audio files (whole or sliced
by start_time / end_time) → (fbank features (T, F) float32, token ids
int32). Host augmentation is not ported: `check_no_augmentation` refuses a
config that enables any.
"""
import json
import os

import numpy as np

from masr_tpu_torch.audio import AudioSegment
from masr_tpu_torch.data.audio_featurizer import AudioFeaturizer
from masr_tpu_torch.data.manifest import read_manifest
from masr_tpu_torch.data.text_featurizer import TextFeaturizer


def check_no_augmentation(augment_conf_path):
    """Raise if the augmentation JSON at the path enables any augmentor
    (an item with prob > 0): host augmentation (masr_tpu/data/
    augmentation) is not ported."""
    if not augment_conf_path or not os.path.isfile(augment_conf_path):
        return
    with open(augment_conf_path, "r", encoding="utf-8") as f:
        items = json.load(f)
    on = [i.get("type") for i in (items if isinstance(items, list) else [])
          if float(i.get("prob", 0.0)) > 0.0]
    if on:
        raise NotImplementedError(
            f"{augment_conf_path} enables augmentation {on}: host "
            "augmentation is not ported (ROADMAP.md module item 7)")


class MASRDataset(object):
    def __init__(self, preprocess_configs, data_manifest, vocab_filepath,
                 manifest_type="txt", min_duration=0.0, max_duration=20.0,
                 train=False):
        if manifest_type != "txt":
            raise NotImplementedError(
                f"manifest_type {manifest_type!r}: binary manifests are not "
                "ported (ROADMAP.md module item 7)")
        self._audio_featurizer = AudioFeaturizer(train=train,
                                                 **dict(preprocess_configs))
        self._text_featurizer = TextFeaturizer(vocab_filepath) \
            if vocab_filepath else None
        max_duration = float("inf") if max_duration == -1 else max_duration
        self.entries = read_manifest(data_manifest, min_duration=min_duration,
                                     max_duration=max_duration)

    def __len__(self):
        return len(self.entries)

    def __getitem__(self, idx):
        """→ (features (T, F) float32, token ids int32)."""
        entry = self.entries[idx]
        if "start_time" in entry:
            segment = AudioSegment.slice_from_file(
                entry["audio_filepath"], entry["start_time"],
                entry["end_time"])
        else:
            segment = AudioSegment.from_file(entry["audio_filepath"])
        feature = self._audio_featurizer.featurize(segment)
        ids = np.asarray(self._text_featurizer.featurize(entry["text"])
                         if self._text_featurizer else [], dtype=np.int32)
        return feature, ids

    @property
    def durations(self):
        return [e["duration"] for e in self.entries]

    @property
    def feature_dim(self):
        return self._audio_featurizer.feature_dim

    @property
    def vocab_size(self):
        return self._text_featurizer.vocab_size

    @property
    def vocab_list(self):
        return self._text_featurizer.vocab_list
