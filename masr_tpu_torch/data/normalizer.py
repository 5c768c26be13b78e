"""Global feature normalization statistics (port of
masr_tpu/data/normalizer.py:17-67): per-dimension mean and inverse std,
read from or written to the `mean_istd.json` of create_data (keys `mean`,
`istd`, `frame_num`). The model applies them through GlobalCMVN."""
import json
import random

import numpy as np

from masr_tpu_torch.utils.logger import setup_logger

logger = setup_logger()


class FeatureNormalizer(object):
    def __init__(self, mean_istd_filepath=None):
        """mean_istd_filepath: a mean_istd.json to read, or None (no
        statistics until compute_mean_istd)."""
        self.mean = None
        self.istd = None
        if mean_istd_filepath is not None:
            with open(mean_istd_filepath, "r", encoding="utf-8") as f:
                d = json.load(f)
            self.mean = np.asarray(d["mean"], dtype=np.float32)
            self.istd = np.asarray(d["istd"], dtype=np.float32)

    def apply(self, features):
        return (features - self.mean) * self.istd

    def compute_mean_istd(self, manifest_path, featurizer, mean_istd_filepath,
                          num_samples=5000, num_workers=8, eps=1e-20):
        """The statistics of featurizer's features over the manifest's
        utterances (num_samples of them drawn with the global `random` when
        there are more; -1 or 0: all), summed in f64: mean = Σx / n,
        istd = 1 / sqrt(max(Σx² / n - mean², 0) + eps); written to
        mean_istd_filepath and kept (f32). num_workers is accepted for
        masr_tpu's signature and unused there too."""
        from masr_tpu_torch.audio import AudioSegment
        from masr_tpu_torch.data.manifest import read_manifest
        manifest = read_manifest(manifest_path)
        if num_samples > 0 and len(manifest) > num_samples:
            manifest = random.sample(manifest, num_samples)
        dim = featurizer.feature_dim
        sum_x = np.zeros(dim, dtype=np.float64)
        sum_x2 = np.zeros(dim, dtype=np.float64)
        n_frames = 0
        for i, entry in enumerate(manifest):
            if "start_time" in entry:
                seg = AudioSegment.slice_from_file(
                    entry["audio_filepath"], entry["start_time"],
                    entry["end_time"])
            else:
                seg = AudioSegment.from_file(entry["audio_filepath"])
            feats = featurizer.featurize(seg)
            sum_x += feats.sum(axis=0)
            sum_x2 += (feats.astype(np.float64) ** 2).sum(axis=0)
            n_frames += feats.shape[0]
            if (i + 1) % 1000 == 0:
                logger.info(f"normalizer: {i + 1}/{len(manifest)} utterances")
        mean = sum_x / n_frames
        var = np.maximum(sum_x2 / n_frames - mean ** 2, 0.0)
        istd = 1.0 / np.sqrt(var + eps)
        with open(mean_istd_filepath, "w", encoding="utf-8") as f:
            json.dump({"mean": mean.tolist(), "istd": istd.tolist(),
                       "frame_num": int(n_frames)}, f)
        self.mean = mean.astype(np.float32)
        self.istd = istd.astype(np.float32)
        logger.info(f"wrote mean/istd over {n_frames} frames to "
                    f"{mean_istd_filepath}")
