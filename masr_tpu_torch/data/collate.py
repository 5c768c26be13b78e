"""Batch collation (port of masr_tpu/data/collate.py: collate_fn :15,
collate_waveforms :41): features (or, for the on-device frontend, int16-
scale samples) zero-padded to the batch's longest, rounded up to a
multiple of feature_bucket frames (sample_bucket samples), labels padded
with -1 to a multiple of label_bucket."""
import numpy as np


def bucket_length(n: int, multiple: int) -> int:
    return int(-(-n // multiple) * multiple) if multiple > 1 else int(n)


def collate_fn(batch, feature_bucket=16, label_bucket=8, shuffle=True,
               rng=None):
    """[(features (T, F), ids)] → {"inputs": (B, T_max, F) f32,
    "input_lens": (B,) i32, "labels": (B, L_max) i32 (-1 padded),
    "label_lens": (B,) i32}; the order is shuffled with `rng`."""
    if shuffle:
        order = (rng or np.random).permutation(len(batch))
        batch = [batch[i] for i in order]
    feat_dim = batch[0][0].shape[1]
    max_t = bucket_length(max(f.shape[0] for f, _ in batch), feature_bucket)
    max_l = max(1, bucket_length(max(len(l) for _, l in batch),
                                 label_bucket))
    B = len(batch)
    inputs = np.zeros((B, max_t, feat_dim), dtype=np.float32)
    labels = np.full((B, max_l), -1, dtype=np.int32)
    input_lens = np.zeros(B, dtype=np.int32)
    label_lens = np.zeros(B, dtype=np.int32)
    for i, (feat, lab) in enumerate(batch):
        inputs[i, :feat.shape[0]] = feat
        labels[i, :len(lab)] = lab
        input_lens[i] = feat.shape[0]
        label_lens[i] = len(lab)
    return {"inputs": inputs, "input_lens": input_lens,
            "labels": labels, "label_lens": label_lens}


def collate_waveforms(batch, sample_bucket=16000, label_bucket=8,
                      shuffle=True, rng=None):
    """[(samples (S,), ids)] → {"inputs": (B, S_max) f32, "input_lens":
    (B,) i32 samples, "labels", "label_lens"} for the on-device frontend;
    S_max rounded up to a multiple of sample_bucket (1 s by default); the
    order is shuffled with `rng`."""
    if shuffle:
        order = (rng or np.random).permutation(len(batch))
        batch = [batch[i] for i in order]
    max_s = bucket_length(max(len(w) for w, _ in batch), sample_bucket)
    max_l = max(1, bucket_length(max(len(l) for _, l in batch),
                                 label_bucket))
    B = len(batch)
    inputs = np.zeros((B, max_s), dtype=np.float32)
    labels = np.full((B, max_l), -1, dtype=np.int32)
    input_lens = np.zeros(B, dtype=np.int32)
    label_lens = np.zeros(B, dtype=np.int32)
    for i, (wav, lab) in enumerate(batch):
        inputs[i, :len(wav)] = wav
        labels[i, :len(lab)] = lab
        input_lens[i] = len(wav)
        label_lens[i] = len(lab)
    return {"inputs": inputs, "input_lens": input_lens,
            "labels": labels, "label_lens": label_lens}
