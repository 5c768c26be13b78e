"""The on-device input frontend (port of masr_tpu/ops/specaug.py): batched
SpecAugment and SpecSub on tensors, fbank → SpecAugment, and the frontend
the train step runs on the card before the encoder
(dataset_conf.on_device_frontend).

Each transform is split in two: `draw_*` makes the random widths, starts
and positions from an explicit torch.Generator on the features' device,
and `apply_*` is deterministic given them, so that a test can feed it the
draws masr_tpu makes from a JAX key. Masks come from comparisons of
position ranges against the drawn scalars, so one code path serves every
draw and no host loop runs per utterance; the draws have masr_tpu's
ranges and distributions, not its bits (masr_tpu draws from JAX keys).
fbank runs through ops/fbank.py `fbank_torch`.
"""
import torch

from masr_tpu_torch.ops.fbank import fbank_torch


def _uniform_int(gen, shape, high, device):
    """Integers uniform over [0, high) (high a tensor broadcast to shape,
    >= 1), as masr_tpu's (uniform × span).astype(int32)."""
    u = torch.rand(shape, generator=gen, device=device)
    return (u * high).to(torch.int64)


def draw_mask_axis(gen, B, n_masks, max_width, limit, device):
    """n_masks masks per utterance: widths uniform over [0, max_width],
    starts uniform over [0, max(limit − width, 1)) (limit: the axis length,
    or (B,) valid lengths) → (widths, starts), each (B, n_masks) int64."""
    widths = torch.randint(0, max_width + 1, (B, n_masks), generator=gen,
                           device=device)
    limit = torch.as_tensor(limit, device=device).reshape(-1, 1)
    starts = _uniform_int(gen, (B, n_masks),
                          torch.clamp(limit - widths, min=1), device)
    return widths, starts


def _keep(widths, starts, axis_len):
    """(B, n) masks → (B, axis_len) bool: positions no mask covers."""
    pos = torch.arange(axis_len, device=widths.device)[None, None, :]
    hit = (pos >= starts[..., None]) & (pos < (starts + widths)[..., None])
    return ~hit.any(dim=1)


def draw_specaug(gen, feats, lens, n_freq_masks=2, n_time_masks=2,
                 max_f=10, max_t=50):
    """SpecAugment's draws for feats (B, T, F) with lens (B,) valid frames:
    {"f_widths", "f_starts"} over the F bins, {"t_widths", "t_starts"}
    within each utterance's valid frames."""
    B, T, F = feats.shape
    dev = feats.device
    f_w, f_s = draw_mask_axis(gen, B, n_freq_masks, max_f, F, dev)
    t_w, t_s = draw_mask_axis(gen, B, n_time_masks, max_t, lens, dev)
    return {"f_widths": f_w, "f_starts": f_s, "t_widths": t_w,
            "t_starts": t_s}


def apply_specaug(feats, lens, draws, replace_with_zero=False):
    """Frequency and time masks of `draws` over feats (B, T, F), filled
    with each utterance's mean over its valid frames (or 0) → (B, T, F)."""
    B, T, F = feats.shape
    keep = _keep(draws["f_widths"], draws["f_starts"], F)[:, None, :] \
        & _keep(draws["t_widths"], draws["t_starts"], T)[:, :, None]
    if replace_with_zero:
        fill = feats.new_zeros((B, 1, 1))
    else:
        lens = lens.to(feats.device)
        valid = (torch.arange(T, device=feats.device)[None, :]
                 < lens[:, None])[..., None]
        fill = (torch.where(valid, feats, 0.0).sum(dim=(1, 2))
                / torch.clamp(lens * F, min=1))[:, None, None]
    return torch.where(keep, feats, fill.to(feats.dtype))


def specaug(feats, lens, gen, n_freq_masks=2, n_time_masks=2, max_f=10,
            max_t=50, replace_with_zero=False):
    """Batched SpecAugment (masr_tpu's specaug_jax): draw, then apply."""
    draws = draw_specaug(gen, feats, lens, n_freq_masks, n_time_masks,
                         max_f, max_t)
    return apply_specaug(feats, lens, draws, replace_with_zero)


def draw_specsub(gen, lens, max_t=20, num_t_sub=3):
    """SpecSub's draws, num_t_sub per utterance (lens (B,) valid frames):
    span lengths uniform over [1, max_t], starts over [0, max(len, 1)),
    positions back over [0, start] → {"t", "start", "pos"}, each
    (num_t_sub, B) int64."""
    dev = lens.device
    B = lens.shape[0]
    out = {"t": [], "start": [], "pos": []}
    for _ in range(num_t_sub):
        t = torch.randint(1, max(max_t, 1) + 1, (B,), generator=gen,
                          device=dev)
        start = _uniform_int(gen, (B,), torch.clamp(lens, min=1), dev)
        pos = _uniform_int(gen, (B,), start + 1, dev)
        for k, v in (("t", t), ("start", start), ("pos", pos)):
            out[k].append(v)
    return {k: torch.stack(v) for k, v in out.items()}


def apply_specsub(feats, lens, draws):
    """Each drawn span within the valid frames takes the ORIGINAL frames
    `pos` earlier; later spans override earlier ones. One source-index map
    and one gather → (B, T, F)."""
    B, T, F = feats.shape
    lens = lens.to(feats.device)
    idx = torch.arange(T, device=feats.device)[None, :].expand(B, T)
    src = idx
    for t, start, pos in zip(draws["t"], draws["start"], draws["pos"]):
        span = ((idx >= start[:, None]) & (idx < (start + t)[:, None])
                & (idx < lens[:, None]))
        src = torch.where(span, idx - pos[:, None], src)
    return torch.gather(feats, 1, src[:, :, None].expand(B, T, F))


def specsub(feats, lens, gen, max_t=20, num_t_sub=3):
    """Batched SpecSub (masr_tpu's specsub_jax): draw, then apply."""
    return apply_specsub(feats, lens, draw_specsub(gen, lens.to(feats.device),
                                                   max_t, num_t_sub))


def fbank_specaug(waveform, lengths, gen, num_mel_bins=80, dither=1.0,
                  sample_rate=16000, **specaug_kwargs):
    """int16-scale waveforms (B, S) with lengths (B,) samples → fbank (with
    dither from `gen`) → SpecAugment → (feats (B, T, n_mels), feat lens)."""
    feats, feat_lens = fbank_torch(waveform, lengths,
                                   num_mel_bins=num_mel_bins, dither=dither,
                                   sample_rate=sample_rate, generator=gen)
    return specaug(feats, feat_lens, gen, **specaug_kwargs), feat_lens


def make_device_frontend(preprocess_conf, specaug_conf=None,
                         specsub_conf=None):
    """→ frontend(waveforms, sample_lens, generator, train) → (feats (B, T,
    n_mels), lens (B,) int64) on the waveforms' device. Train: fbank with
    dither 1, SpecAugment, then SpecSub when specsub_conf is given; eval:
    fbank with dither 0 and nothing drawn. The confs are the augmentation
    JSON's specaug and specsub params (F, T, n_freq_masks, n_time_masks;
    max_t, num_t_sub)."""
    pre = dict(preprocess_conf or {})
    method = pre.get("feature_method", "fbank")
    if method != "fbank":
        raise ValueError(f"on-device frontend supports fbank (got {method})")
    n_mels = int(pre.get("n_mels", 80))
    sr = int(pre.get("sample_rate", 16000))
    sa = dict(specaug_conf or {})
    kwargs = dict(n_freq_masks=int(sa.get("n_freq_masks", 2)),
                  n_time_masks=int(sa.get("n_time_masks", 2)),
                  max_f=int(sa.get("F", sa.get("max_f", 10))),
                  max_t=int(sa.get("T", sa.get("max_t", 50))))
    ss = dict(specsub_conf) if specsub_conf else None

    def frontend(waveforms, sample_lens, generator, train):
        if train:
            feats, lens = fbank_specaug(waveforms, sample_lens, generator,
                                        num_mel_bins=n_mels, dither=1.0,
                                        sample_rate=sr, **kwargs)
            if ss is not None:
                feats = specsub(feats, lens, generator,
                                max_t=int(ss.get("max_t", 20)),
                                num_t_sub=int(ss.get("num_t_sub", 3)))
        else:
            feats, lens = fbank_torch(waveforms, sample_lens,
                                      num_mel_bins=n_mels, dither=0.0,
                                      sample_rate=sr)
        return feats, lens.long()

    return frontend
