"""Inference bundles (port of masr_tpu/infer/bundle.py:99-120).

A bundle directory holds inference.json (model + preprocess config and the
CMVN statistics), model.msgpack (flax params, read here without flax) and
vocabulary.txt. Quantized bundles load as f32: bfloat16 leaves are widened
by the reader, int8 leaves are dequantized per last-axis scale in the flax
layout, before the weight map transposes anything (bundle.py:40-50).
"""
import json
import os

import numpy as np

from masr_tpu_torch.data.text_featurizer import TextFeaturizer
from masr_tpu_torch.infer import flax_msgpack
from masr_tpu_torch.models.cmvn import GlobalCMVN
from masr_tpu_torch.models.registry import build_model
from masr_tpu_torch.models.weights import from_flax_variables


def _dequantize_int8(tree):
    if isinstance(tree, dict):
        if set(tree) == {"q", "scale"}:
            return (np.asarray(tree["q"], np.float32)
                    * np.asarray(tree["scale"], np.float32))
        return {k: _dequantize_int8(v) for k, v in tree.items()}
    return tree


def load_inference_bundle(bundle_dir):
    """→ (model in eval mode on the CPU, meta dict, vocab_list)."""
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
        cmvn=GlobalCMVN(meta["mean"], meta["istd"]))
    with open(os.path.join(bundle_dir, "model.msgpack"), "rb") as f:
        variables = flax_msgpack.unpackb(f.read())
    if meta.get("quantization") == "int8":
        variables = _dequantize_int8(variables)
    model.load_state_dict(from_flax_variables(variables))
    return model.eval(), meta, vocab_list
