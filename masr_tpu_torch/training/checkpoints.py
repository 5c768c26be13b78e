"""Checkpoints (port of masr_tpu/training/checkpoints.py, in torch's
format): `epoch_N/` holds `state.pt` (the model state_dict under upstream
names, optimizer, scheduler, step counts and accumulation state, from
TrainState.state_dict) and `model.state` JSON (last_epoch and metrics);
`last_model/` and `best_model/` are copies (hard links where the file
system allows: a checkpoint is never modified once written); epoch
N - keep_last is removed.
`latest_checkpoint` finds last_model for auto-resume."""
import json
import logging
import os
import shutil

import torch

logger = logging.getLogger("masr_tpu_torch")


def save_checkpoint(save_dir, epoch, state_dict, metrics=None, best=False,
                    keep_last=3):
    """Write epoch_<epoch> and refresh last_model (and best_model if
    best) → the epoch directory."""
    save_dir = os.path.abspath(save_dir)
    os.makedirs(save_dir, exist_ok=True)
    path = os.path.join(save_dir, f"epoch_{epoch}")
    if os.path.exists(path):
        shutil.rmtree(path)
    os.makedirs(path)
    torch.save(state_dict, os.path.join(path, "state.pt"))
    meta = {"last_epoch": int(epoch)}
    meta.update(metrics or {})
    with open(os.path.join(path, "model.state"), "w", encoding="utf-8") as f:
        json.dump(meta, f)
    _refresh_copy(path, os.path.join(save_dir, "last_model"))
    if best:
        _refresh_copy(path, os.path.join(save_dir, "best_model"))
    old = os.path.join(save_dir, f"epoch_{epoch - keep_last}")
    if os.path.exists(old):
        shutil.rmtree(old, ignore_errors=True)
    logger.info(f"checkpoint saved: {path}")
    return path


def _link_or_copy(src, dst):
    try:
        os.link(src, dst)
    except OSError:
        shutil.copy2(src, dst)


def _refresh_copy(src, dst):
    if os.path.exists(dst):
        shutil.rmtree(dst)
    shutil.copytree(src, dst, copy_function=_link_or_copy)


def load_checkpoint(path, map_location="cpu"):
    """→ (state dict, meta dict) of a checkpoint directory."""
    path = os.path.abspath(path)
    state = torch.load(os.path.join(path, "state.pt"),
                       map_location=map_location, weights_only=False)
    meta = {}
    meta_path = os.path.join(path, "model.state")
    if os.path.exists(meta_path):
        with open(meta_path, "r", encoding="utf-8") as f:
            meta = json.load(f)
    return state, meta


def latest_checkpoint(save_dir):
    """→ save_dir/last_model if it holds a checkpoint, else None."""
    p = os.path.join(os.path.abspath(save_dir), "last_model")
    return p if os.path.exists(os.path.join(p, "model.state")) else None
