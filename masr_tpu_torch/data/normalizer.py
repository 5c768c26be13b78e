"""Global feature normalization statistics (port of
masr_tpu/data/normalizer.py:17, reading only): per-dimension mean and
inverse std from the `mean_istd.json` that create_data writes. The model
applies them through GlobalCMVN."""
import json

import numpy as np


class FeatureNormalizer(object):
    def __init__(self, mean_istd_filepath):
        with open(mean_istd_filepath, "r", encoding="utf-8") as f:
            d = json.load(f)
        self.mean = np.asarray(d["mean"], dtype=np.float32)
        self.istd = np.asarray(d["istd"], dtype=np.float32)

    def apply(self, features):
        return (features - self.mean) * self.istd
