"""LR schedules and the optimizer (port of masr_tpu/optimizer/
schedulers.py: warmup_lr :11, noam_hold_annealing :33, cosine_with_warmup
:58, build_optimizer :82).

A schedule is a pure step → lr function of the optimizer-update count
(0 for the first update), as in masr_tpu; `build_optimizer` wraps it in a
torch LambdaLR, stepped once per optimizer update. Adam's weight_decay is
torch's L2, added to the (clipped) grad before the moments: the same as
masr_tpu's optax.add_decayed_weights → adam. Gradient clipping and
accum_grad live in training/train_state.py.

optimizer_conf.fused (masr_tpu/optimizer/fused.py, one XLA fusion of the
clip, the decay and the Adam update) is torch's fused Adam / AdamW (the
update in multi-tensor kernels over groups of parameters), after the
train step's clip: the same update as the unfused chain.
"""
import math

import torch


def warmup_lr(learning_rate, warmup_steps=25000, min_lr=1e-5):
    """lr · warmup^0.5 · min(n^-0.5, n · warmup^-1.5), n = step + 1; the
    min_lr floor only after warmup."""
    def schedule(step):
        n = max(step + 1, 1)
        if warmup_steps == 0:
            return max(learning_rate * n ** -0.5, min_lr)
        lr = learning_rate * warmup_steps ** 0.5 * min(
            n ** -0.5, n * warmup_steps ** -1.5)
        return min_lr if lr < min_lr and n > warmup_steps else lr
    return schedule


def noam_hold_annealing(learning_rate, max_steps=175680, warmup_steps=None,
                        warmup_ratio=0.2, hold_steps=None, hold_ratio=0.3,
                        decay_rate=1.0, min_lr=1e-5):
    """Linear warmup → hold at the peak → polynomial decay."""
    if warmup_steps is None:
        warmup_steps = int((warmup_ratio or 0.0) * max_steps)
    if hold_steps is None:
        hold_steps = int((hold_ratio or 0.0) * max_steps)
    hold_end = hold_steps + warmup_steps

    def schedule(step):
        if step > max_steps:
            return min_lr
        if step <= warmup_steps:
            return learning_rate * (step + 1) / (warmup_steps + 1)
        if step < hold_end:
            return learning_rate
        t_warm = max(1.0, warmup_steps ** decay_rate)
        t_hold = max(1.0, max(step - hold_steps, 1.0) ** decay_rate)
        return max(learning_rate * t_warm / t_hold, min_lr)
    return schedule


def cosine_with_warmup(learning_rate, T_max, eta_min=0.0, warmup_steps=None,
                       warmup_ratio=0.2):
    """Linear warmup → cosine annealing to eta_min."""
    if warmup_steps is None:
        warmup_steps = int((warmup_ratio or 0.0) * T_max)
    T = max(T_max - warmup_steps, 1)

    def schedule(step):
        if step <= warmup_steps:
            return learning_rate * (step + 1) / (warmup_steps + 1)
        s = min(max(step - warmup_steps, 0.0) / T, 1.0)
        return eta_min + (learning_rate - eta_min) * 0.5 * (
            1 + math.cos(math.pi * s))
    return schedule


def build_lr_schedule(scheduler, learning_rate, scheduler_conf):
    conf = dict(scheduler_conf or {})
    if scheduler == "WarmupLR":
        return warmup_lr(learning_rate, **conf)
    if scheduler == "NoamHoldAnnealing":
        return noam_hold_annealing(learning_rate, **conf)
    if scheduler == "CosineWithWarmup":
        return cosine_with_warmup(learning_rate, **conf)
    raise ValueError(f"unsupported scheduler: {scheduler}")


def build_optimizer(params, optimizer_conf):
    """→ (torch optimizer, LambdaLR, schedule) for optimizer_conf (the
    configs' optimizer_conf: optimizer, learning_rate, weight_decay,
    scheduler, scheduler_conf, fused). Adam (L2 weight decay), AdamW, SGD;
    fused makes Adam and AdamW torch's fused ones (SGD ignores it)."""
    conf = dict(optimizer_conf)
    name = conf.get("optimizer", "Adam")
    lr = float(conf.get("learning_rate", 1e-3))
    wd = float(conf.get("weight_decay", 0.0))
    schedule = build_lr_schedule(conf.get("scheduler", "WarmupLR"), lr,
                                 conf.get("scheduler_conf"))
    params = list(params)
    # None, not False, when unfused: an explicit False also turns off
    # torch's multi-tensor (foreach) default, for a loop over parameters
    fused = True if conf.get("fused", False) else None
    if name == "Adam":
        opt = torch.optim.Adam(params, lr=lr, weight_decay=wd, fused=fused)
    elif name == "AdamW":
        opt = torch.optim.AdamW(params, lr=lr, weight_decay=wd, fused=fused)
    elif name == "SGD":
        opt = torch.optim.SGD(params, lr=lr,
                              momentum=conf.get("momentum", 0.9))
    else:
        raise ValueError(f"unsupported optimizer: {name}")
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, lambda step: schedule(step) / lr)
    return opt, sched, schedule
