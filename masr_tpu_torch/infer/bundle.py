"""Inference bundles (port of masr_tpu/infer/bundle.py): one format for
both packages.

A bundle directory holds inference.json (model + preprocess config and the
CMVN statistics), model.msgpack (flax params, and batch_stats for a model
with BatchNorm; written and read here without flax) and vocabulary.txt.
`save_inference_bundle` writes the files masr_tpu's exporter writes, byte
for byte, from the same flax variables (models/weights.py
`to_flax_variables` makes them from a state_dict): f32, bf16 (every f32
leaf rounded to nearest even by torch's conversion, as jnp's astype
rounds) or int8 (weight-only, a per-channel scale over the flax layout's
last axis, masr_tpu's numpy operations in their order). Quantized bundles
load as f32: bfloat16 leaves are widened by the reader, int8 leaves are
dequantized per last-axis scale in the flax layout, before the weight map
transposes anything. `load_inference_bundle(dir, dtype=torch.bfloat16)`
builds the model to compute in bf16 (masr_tpu's dtype=bf16): its
parameters stay f32 (a bf16 bundle's values exactly), the products take
them in bf16.
"""
import json
import os

import numpy as np
import torch

from masr_tpu_torch.data.text_featurizer import TextFeaturizer
from masr_tpu_torch.infer import flax_msgpack
from masr_tpu_torch.models.cmvn import GlobalCMVN
from masr_tpu_torch.models.registry import build_model
from masr_tpu_torch.models.weights import from_flax_variables


def _map_leaves(fn, tree):
    """fn over every leaf of a nested dict; the dicts come back with their
    keys sorted, as jax.tree.map returns them (masr_tpu quantizes through
    it, so its quantized bundles store sorted keys)."""
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, tree[k]) for k in sorted(tree)}
    return fn(tree)


def _to_bf16(x):
    x = np.asarray(x)
    if x.dtype != np.float32:
        return x
    return torch.from_numpy(np.ascontiguousarray(x)).to(torch.bfloat16)


def _quantize_int8(x):
    """An f32 leaf of ndim >= 2 → {'q': int8, 'scale': f32 over the last
    axis} (masr_tpu/infer/bundle.py _quantize_int8); other leaves as
    they are."""
    x = np.asarray(x)
    if x.dtype != np.float32 or x.ndim < 2:
        return x
    amax = np.max(np.abs(x), axis=tuple(range(x.ndim - 1)))
    scale = np.maximum(amax, 1e-8).astype(np.float32) / 127.0
    return {"q": np.clip(np.round(x / scale), -127, 127).astype(np.int8),
            "scale": scale}


def save_inference_bundle(out_dir, use_model, streaming, input_dim,
                          vocab_list, mean, istd, encoder_conf, decoder_conf,
                          model_conf, preprocess_conf, variables,
                          half=False, quant=None):
    """Write a bundle from flax `variables` ({'params': ...[,
    'batch_stats': ...]} of f32 numpy arrays). quant: None (f32), 'bf16'
    (half=True is an alias) or 'int8'."""
    quant = quant or ("bf16" if half else None)
    if quant == "bf16":
        variables = _map_leaves(_to_bf16, variables)
    elif quant == "int8":
        variables = _map_leaves(_quantize_int8, variables)
    elif quant is not None:
        raise ValueError(f"unknown quant mode: {quant}")
    os.makedirs(out_dir, exist_ok=True)
    meta = {
        "framework": "masr_tpu",
        "use_model": use_model,
        "streaming": bool(streaming),
        "input_dim": int(input_dim),
        "vocab_size": len(vocab_list),
        "mean": np.asarray(mean, dtype=np.float64).tolist(),
        "istd": np.asarray(istd, dtype=np.float64).tolist(),
        "encoder_conf": dict(encoder_conf or {}),
        "decoder_conf": dict(decoder_conf or {}),
        "model_conf": dict(model_conf or {}),
        "preprocess_conf": dict(preprocess_conf or {}),
        "quantization": quant,
    }
    with open(os.path.join(out_dir, "inference.json"), "w",
              encoding="utf-8") as f:
        json.dump(meta, f, ensure_ascii=False)
    with open(os.path.join(out_dir, "vocabulary.txt"), "w",
              encoding="utf-8") as f:
        for tok in vocab_list:
            f.write(tok + "\t-1\n")
    with open(os.path.join(out_dir, "model.msgpack"), "wb") as f:
        f.write(flax_msgpack.packb(variables))


def _dequantize_int8(tree):
    if isinstance(tree, dict):
        if set(tree) == {"q", "scale"}:
            return (np.asarray(tree["q"], np.float32)
                    * np.asarray(tree["scale"], np.float32))
        return {k: _dequantize_int8(v) for k, v in tree.items()}
    return tree


def load_inference_bundle(bundle_dir, dtype=None):
    """→ (model in eval mode on the CPU, meta dict, vocab_list). dtype: the
    compute dtype (None: f32; bf16 for every family)."""
    with open(os.path.join(bundle_dir, "inference.json"), "r",
              encoding="utf-8") as f:
        meta = json.load(f)
    vocab_list = TextFeaturizer(
        os.path.join(bundle_dir, "vocabulary.txt")).vocab_list
    model = build_model(
        meta["use_model"], meta["input_dim"], meta["vocab_size"],
        streaming=meta["streaming"], encoder_conf=meta["encoder_conf"],
        decoder_conf=meta.get("decoder_conf"),
        model_conf=meta.get("model_conf"),
        cmvn=GlobalCMVN(meta["mean"], meta["istd"]),
        dtype=dtype or torch.float32)
    with open(os.path.join(bundle_dir, "model.msgpack"), "rb") as f:
        variables = flax_msgpack.unpackb(f.read())
    if meta.get("quantization") == "int8":
        variables = _dequantize_int8(variables)
    missing, unexpected = model.load_state_dict(
        from_flax_variables(variables), strict=False)
    # BatchNorm's num_batches_tracked is not in a flax bundle (and only
    # matters to training with momentum None)
    missing = [k for k in missing if not k.endswith("num_batches_tracked")]
    if missing or unexpected:
        raise RuntimeError(f"bundle weights do not fit the model: missing "
                           f"{missing}, unexpected {unexpected}")
    return model.eval(), meta, vocab_list
