"""AugmentationPipeline (port of masr_tpu/data/augmentation/pipeline.py).

The config is a JSON list (a path to one, or its text); each item is
{"type", "aug_type": "audio" | "feature", "params", "prob"} and fires
independently with probability prob. Every augmentor shares the
pipeline's one random.Random(seed), as masr_tpu's do, so that a seed gives
masr_tpu's draws. A noise augmentor whose manifest is missing is dropped
with a warning.
"""
import json
import logging
import os
import random

from masr_tpu_torch.data.augmentation import augmentors as A

logger = logging.getLogger("masr_tpu_torch")

_AUDIO_TYPES = {
    "noise": A.NoisePerturbAugmentor,
    "speed": A.SpeedPerturbAugmentor,
    "volume": A.VolumePerturbAugmentor,
    "shift": A.ShiftPerturbAugmentor,
    "resample": A.ResampleAugmentor,
}
_FEATURE_TYPES = {
    "specaug": A.SpecAugmentor,
    "specsub": A.SpecSubAugmentor,
}


def enabled_items(augmentation_config):
    """The items of an augmentation config (a path to its JSON, the JSON
    text, or None) with prob > 0, in their order."""
    if os.path.isfile(str(augmentation_config)):
        with open(augmentation_config, "r", encoding="utf-8") as f:
            augmentation_config = f.read()
    try:
        configs = json.loads(augmentation_config) \
            if augmentation_config else []
    except json.JSONDecodeError as e:
        raise ValueError(f"bad augmentation config: {e}")
    if not isinstance(configs, list):
        return []
    return [c for c in configs if float(c.get("prob", 0.0)) > 0.0]


class AugmentationPipeline(object):
    def __init__(self, augmentation_config="{}", seed=None):
        self._rng = random.Random(seed)
        self._audio_augmentors = []   # (augmentor, prob)
        self._feature_augmentors = []
        for cfg in enabled_items(augmentation_config):
            kind = cfg.get("type")
            prob = float(cfg.get("prob", 0.0))
            params = dict(cfg.get("params", {}))
            if kind == "noise":
                manifest = params.get("noise_manifest_path")
                if not (manifest and os.path.exists(manifest)):
                    logger.warning(f"noise augmentor dropped: manifest "
                                   f"missing ({manifest})")
                    continue
            if kind in _AUDIO_TYPES:
                self._audio_augmentors.append(
                    (_AUDIO_TYPES[kind](self._rng, **params), prob))
            elif kind in _FEATURE_TYPES:
                self._feature_augmentors.append(
                    (_FEATURE_TYPES[kind](self._rng, **params), prob))
            else:
                raise ValueError(f"unknown augmentor type: {kind}")

    def transform_audio(self, audio_segment):
        """Apply the audio augmentors in place."""
        for aug, prob in self._audio_augmentors:
            if self._rng.random() < prob:
                aug.transform_audio(audio_segment)

    def transform_feature(self, feature):
        for aug, prob in self._feature_augmentors:
            if self._rng.random() < prob:
                feature = aug.transform_feature(feature)
        return feature
