"""Attention rescoring of a CTC n-best (the arithmetic of
masr_tpu/infer/predictor.py:219-242 and masr_tpu/training/trainer.py:444-475,
shared here by the predictor and the trainer's eval).

The hypotheses are padded to masr_tpu's fixed shapes, nbest_pad rows of a
length rounded up to a multiple of 8; a padded row is empty and changes no
real row's score. The model is any family with `rescore_hyps`
(models/conformer.py, inherited by the Squeezeformer).
"""
import numpy as np
import torch


def pad_hyps(hyps_list, nbest_pad, len_bucket=8):
    """Token-id lists → (hyps (nbest_pad, L) int64, -1-padded; lengths
    (nbest_pad,) int64), L the longest rounded up to len_bucket; only the
    first nbest_pad hypotheses are kept."""
    L = max(max((len(h) for h in hyps_list), default=1), 1)
    L = -(-L // len_bucket) * len_bucket
    hyps = torch.full((nbest_pad, L), -1, dtype=torch.int64)
    lengths = torch.zeros((nbest_pad,), dtype=torch.int64)
    for i, h in enumerate(hyps_list[:nbest_pad]):
        hyps[i, : len(h)] = torch.as_tensor(h, dtype=torch.int64)
        lengths[i] = len(h)
    return hyps, lengths


@torch.no_grad()
def attention_scores(model, encoder_out, encoder_len, hyps_list,
                     reverse_weight=0.0, nbest_pad=10, len_bucket=8):
    """The attention decoder's scores of the hypotheses over one
    utterance's encoder rows (1, T, D), on their device → (N,) ndarray
    (N = min(len(hyps_list), nbest_pad))."""
    hyps, lengths = pad_hyps(hyps_list, nbest_pad, len_bucket)
    dev = encoder_out.device
    scores = model.rescore_hyps(encoder_out, int(encoder_len), hyps.to(dev),
                                lengths.to(dev),
                                reverse_weight=reverse_weight)
    return scores.cpu().numpy()[: min(len(hyps_list), nbest_pad)]


def rescore_nbest(model, encoder_out, encoder_len, nbest, ctc_weight,
                  reverse_weight=0.0, nbest_pad=10):
    """nbest [(ctc score, token ids)] → (score, token ids) of the best
    non-empty hypothesis by att + ctc_weight · ctc, or None when every
    hypothesis is empty."""
    nbest = [(s, ids) for s, ids in nbest if len(ids) > 0]
    if not nbest:
        return None
    att = attention_scores(model, encoder_out, encoder_len,
                           [ids for _, ids in nbest], reverse_weight,
                           nbest_pad)
    totals = [a + ctc_weight * s for a, (s, _) in zip(att, nbest)]
    best = int(np.argmax(totals))
    return float(totals[best]), nbest[best][1]
