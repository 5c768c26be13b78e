"""Shared model utilities (port of masr_tpu/ops/common.py: get_activation,
add_sos_eos :23, reverse_pad_list :45, th_accuracy :57) and the dropout of
the modules that run outside the kernels."""
import torch
import torch.nn.functional as F

IGNORE_ID = -1


def get_activation(name: str):
    """Activation by config name (masr_tpu/ops/common.py:8-20). The port
    takes swish (every shipped Conformer encoder) and relu (the attention
    decoder's FFN)."""
    acts = {"swish": F.silu, "relu": F.relu}
    if name not in acts:
        raise NotImplementedError(f"activation {name!r} is not ported yet")
    return acts[name]


def dropout(x, rate, training, generator=None):
    """Inverted dropout drawn from `generator` (on x's device; None = the
    global generator); identity outside training or at rate 0."""
    if not training or rate <= 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device,
                      dtype=x.dtype) >= rate
    return x * keep / (1.0 - rate)


def add_sos_eos(ys_pad, ys_lens, sos, eos, ignore_id=IGNORE_ID):
    """ys_pad (B, L) padded with ignore_id, ys_lens (B,) →
    ys_in (B, L+1) = [sos, y..., eos-padded] and
    ys_out (B, L+1) = [y..., eos, ignore-padded]."""
    B, L = ys_pad.shape
    ys = torch.where(ys_pad == ignore_id, torch.zeros_like(ys_pad), ys_pad)
    pos = torch.arange(L + 1, device=ys_pad.device)[None, :]
    n = ys_lens.to(ys_pad.device)[:, None]
    ys_in = torch.cat([torch.full((B, 1), sos, dtype=ys.dtype,
                                  device=ys.device), ys], dim=1)
    ys_in = torch.where(pos <= n, ys_in, torch.full_like(ys_in, eos))
    ys_out = torch.cat([ys, torch.full((B, 1), ignore_id, dtype=ys.dtype,
                                       device=ys.device)], dim=1)
    ys_out = torch.where(pos == n, torch.full_like(ys_out, eos), ys_out)
    ys_out = torch.where(pos > n, torch.full_like(ys_out, ignore_id), ys_out)
    return ys_in, ys_out


def reverse_pad_list(ys_pad, ys_lens, pad_value=IGNORE_ID):
    """Reverse each row within its length; positions past it get
    pad_value."""
    L = ys_pad.shape[1]
    pos = torch.arange(L, device=ys_pad.device)[None, :]
    rev = ys_lens.to(ys_pad.device)[:, None] - 1 - pos
    out = ys_pad.gather(1, torch.clamp(rev, min=0))
    return torch.where(rev >= 0, out, torch.full_like(out, pad_value))


def th_accuracy(pad_outputs, pad_targets, ignore_label=IGNORE_ID):
    """Token accuracy over non-ignored positions. pad_outputs (B·L, V)
    logits; pad_targets (B, L)."""
    B, L = pad_targets.shape
    pred = pad_outputs.reshape(B, L, -1).argmax(dim=2)
    mask = pad_targets != ignore_label
    num = ((pred == pad_targets) & mask).sum()
    return num.float() / torch.clamp(mask.sum(), min=1).float()
