"""Flax param trees ↔ the port's state_dict (upstream MASR names), and
masr_tpu's streaming attention caches ↔ the port's ring layout.

The weight map is the exact inverse of masr_tpu/models/convert.py (`_t`,
`_conv2d`, `_dw_conv1d`, `_pw_conv1d`, `_subsample_linear`,
convert.py:27-51, and `convert_squeezeformer`, :262-369), so the port loads
masr_tpu bundles directly, and an upstream MASR state_dict is already in
the port's format. Attention-decoder weights pass through under their
upstream names (`decoder.left_decoder...`). A Squeezeformer bundle also
carries `batch_stats`, the conv modules' BatchNorm running statistics
(flax `.../conv_module/conv/norm/{mean,var}` ↔ upstream
`...conv_module.norm.running_{mean,var}`); `num_batches_tracked` is neither
read nor written.

Attention caches: masr_tpu keeps chronological row j (0 = oldest) of a
slot at row j of a right-aligned (..., B, h, C, 2·d_k) array, or, in its
batch engine, at row wptr + j of a mirrored (B, h, 2·C, >= 2·d_k) TPU ring
per layer. The port keeps it at row (wptr + j) mod C of a single-copy
(..., B, h, C, 2·d_k) ring (models/conformer.py). The cnn caches, offsets
and cache lengths have the same layout in both packages.
"""
import re

import numpy as np
import torch

# flax dotted path → upstream name, applied in order (the inverse below)
_NAME_RULES = [
    (r"^encoder\.layer_(\d+)\.", r"encoder.encoders.\1."),
    (r"^decoder\.(left|right)_decoder\.layer_(\d+)\.",
     r"decoder.\1_decoder.decoders.\2."),
    (r"^encoder\.embed\.conv1\.", "encoder.embed.conv.0."),
    (r"^encoder\.embed\.conv2\.", "encoder.embed.conv.2."),
    (r"^encoder\.embed\.out\.", "encoder.embed.out.0."),
    (r"^encoder\.embed\.input_proj\.", "encoder.embed.input_proj.0."),
    (r"\.embed\.embedding$", ".embed.0.weight"),
    # Squeezeformer: the flax AdaptiveScale submodule `ada` and the inner
    # ConvolutionModule `conv` are not in the upstream names
    (r"\.ada\.(ada_scale|ada_bias)$", r".\1"),
    (r"\.conv_module\.conv\.", ".conv_module."),
    (r"\.(kernel|scale)$", ".weight"),
]
_INVERSE_RULES = [
    (r"^encoder\.encoders\.(\d+)\.", r"encoder.layer_\1."),
    (r"^decoder\.(left|right)_decoder\.decoders\.(\d+)\.",
     r"decoder.\1_decoder.layer_\2."),
    (r"^encoder\.embed\.conv\.0\.", "encoder.embed.conv1."),
    (r"^encoder\.embed\.conv\.2\.", "encoder.embed.conv2."),
    (r"^encoder\.embed\.out\.0\.", "encoder.embed.out."),
    (r"^encoder\.embed\.input_proj\.0\.", "encoder.embed.input_proj."),
    (r"\.embed\.0\.weight$", ".embed.embedding"),
    (r"^encoder\.preln\.weight$", "encoder.preln.scale"),
    # LayerNorm and BatchNorm modules are the only others with "norm" in
    # their name
    (r"(norm\w*)\.weight$", r"\1.scale"),
    (r"\.weight$", ".kernel"),
]
# the Squeezeformer's, applied first when the state is one
_SQ_INVERSE_RULES = [
    (r"\.(self_attn|ffn1|ffn2|conv_module)\.(ada_scale|ada_bias)$",
     r".\1.ada.\2"),
    (r"\.conv_module\.(?!ada\.)", ".conv_module.conv."),
]
# batch_stats leaf ↔ BatchNorm buffer
_STAT_RULES = [(r"\.norm\.(mean|var)$", r".norm.running_\1")]
_STAT_INVERSE_RULES = [(r"\.norm\.running_(mean|var)$", r".norm.\1")]


def _rename(name, rules):
    for pattern, repl in rules:
        name = re.sub(pattern, repl, name)
    return name


def _kind(torch_name):
    """Layout transform of one upstream weight name (None = as is)."""
    if re.match(r"encoder\.embed\.(conv\.\d|pw_conv|dw_conv)\.weight$",
                torch_name):
        return "conv2d"
    if torch_name in ("encoder.embed.out.0.weight",
                      "encoder.embed.input_proj.0.weight"):
        return "subsample_linear"
    if re.search(r"conv_module\.pointwise_conv\d\.weight$", torch_name):
        return "pointwise"
    if torch_name.endswith(("conv_module.depthwise_conv.weight",
                            "time_reduction_layer.dw_conv.weight")):
        return "depthwise"
    if torch_name == "encoder.time_reduction_layer.pw_conv.weight":
        return "conv1d_k1"
    if torch_name.endswith(".weight") and "norm" not in torch_name \
            and not torch_name.endswith(".embed.0.weight") \
            and torch_name != "encoder.preln.weight":
        return "linear"
    return None


def _to_torch(kind, w):
    if kind == "conv2d":
        return np.transpose(w, (3, 2, 0, 1))            # HWIO → OIHW
    if kind == "subsample_linear":
        # flax (freq·odim, out), freq-major → torch (out, odim·freq)
        out = w.shape[1]
        return np.transpose(w.reshape(-1, out, out), (2, 1, 0)).reshape(
            out, -1)
    if kind == "pointwise":
        return w.T[:, :, None]                           # (in,out) → (out,in,1)
    if kind in ("depthwise", "conv1d_k1"):
        # (k,1,C) → (C,1,k); flax Conv (1,in,out) → torch (out,in,1)
        return np.transpose(w, (2, 1, 0))
    if kind == "linear":
        return w.T
    return w


def _to_flax(kind, w):
    if kind == "conv2d":
        return np.transpose(w, (2, 3, 1, 0))            # OIHW → HWIO
    if kind == "subsample_linear":
        out = w.shape[0]
        return np.transpose(w.reshape(out, out, -1), (2, 1, 0)).reshape(
            -1, out)
    if kind == "pointwise":
        return w[:, :, 0].T
    if kind in ("depthwise", "conv1d_k1"):
        return np.transpose(w, (2, 1, 0))
    if kind == "linear":
        return w.T
    return w


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def from_flax_variables(variables):
    """{'params': flax tree of numpy arrays[, 'batch_stats': ...]} →
    state_dict {upstream name: f32 torch.Tensor}."""
    if "params" not in variables or \
            not set(variables) <= {"params", "batch_stats"}:
        raise ValueError(f"expected a 'params' collection and optionally "
                         f"'batch_stats', got {sorted(variables)}")
    state = {}
    for collection, rules in (("params", _NAME_RULES),
                              ("batch_stats", _STAT_RULES + _NAME_RULES)):
        for path, w in _flatten(variables.get(collection, {})):
            name = _rename(".".join(path), rules)
            w = _to_torch(_kind(name), np.asarray(w, np.float32))
            state[name] = torch.from_numpy(np.array(w, order="C"))
    return state


def to_flax_variables(state_dict):
    """state_dict {upstream name: tensor} → {'params': flax tree of f32
    numpy arrays}, and 'batch_stats' when the state holds BatchNorm
    running statistics (num_batches_tracked is dropped)."""
    squeeze = "encoder.preln.weight" in state_dict
    out = {}
    for name, w in state_dict.items():
        if name.endswith("num_batches_tracked"):
            continue
        collection, rules = "params", _INVERSE_RULES
        if re.search(r"\.running_(mean|var)$", name):
            collection, rules = "batch_stats", \
                _STAT_INVERSE_RULES + _INVERSE_RULES
        if squeeze:
            rules = _SQ_INVERSE_RULES + rules
        w = _to_flax(_kind(name), w.detach().cpu().numpy().astype(np.float32))
        node = out.setdefault(collection, {})
        *parents, leaf = _rename(name, rules).split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = np.ascontiguousarray(w)
    return out


def grads_to_flax_variables(named_params):
    """{upstream name: parameter} (model.named_parameters()) → {'params':
    flax tree of f32 numpy arrays} holding each parameter's .grad in the
    flax layout (the weight map is linear, so grads map as weights do);
    a parameter without a grad maps to zeros."""
    return to_flax_variables({
        name: p.grad if p.grad is not None else torch.zeros_like(p)
        for name, p in dict(named_params).items()})


# parameters that flax starts at 1: LayerNorm and BatchNorm scales (every
# norm module's name holds "norm", the Squeezeformer's `preln` aside) and
# the Squeezeformer's AdaptiveScale scales
_ONES = re.compile(r"(norm\w*|^encoder\.preln)\.weight$|\.ada_scale$")


@torch.no_grad()
def flax_like_init(model, generator):
    """Re-initialise `model` in place with the distributions masr_tpu's
    flax modules start from (train_conf.init_type "flax"): kernels
    lecun_normal (a normal truncated at ±2σ, σ = 1/√fan_in / 0.8796), biases
    0, LayerNorm and BatchNorm scales and AdaptiveScale scales 1, the
    AdaptiveScale shifts 0, embeddings N(0, 1/d), pos_bias_u/v
    xavier_uniform; drawn from `generator` (CPU)."""
    for name, p in model.named_parameters():
        t = torch.empty(p.shape, dtype=torch.float32)
        if name.endswith("pos_bias_u") or name.endswith("pos_bias_v"):
            torch.nn.init.xavier_uniform_(t, generator=generator)
        elif _ONES.search(name):
            t.fill_(1.0)
        elif name.endswith(".embed.0.weight"):
            # flax nn.Embed: variance_scaling(1, fan_in, normal, out_axis=0)
            t.normal_(0.0, 1.0 / np.sqrt(p.shape[1]), generator=generator)
        elif name.endswith(".weight") and p.dim() >= 2:
            std = (1.0 / np.sqrt(np.prod(p.shape[1:]))) / 0.87962566103423978
            torch.nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std,
                                        generator=generator)
        else:
            t.zero_()
        p.copy_(t)


def seeded_state_dict(model, seed):
    """Random weights for `model`, drawn with numpy from `seed`: weights
    U(±1/√fan_in) as torch's default init, norm and adaptive scales
    1 + N(0, 0.1²), BatchNorm running variances U(0.5, 1.5), biases, means
    and the other vectors N(0, 0.05²) (non-zero, so padding semantics
    show); BatchNorm's num_batches_tracked stays as it is. → state_dict of
    tensors (f32 but for that counter)."""
    rs = np.random.RandomState(seed)
    state = {}
    for name, p in model.state_dict().items():
        shape = tuple(p.shape)
        if name.endswith("num_batches_tracked"):
            state[name] = p.clone()
            continue
        if name.endswith("running_var"):
            w = rs.uniform(0.5, 1.5, shape)
        elif ("norm" in name and name.endswith(".weight")) or \
                name.endswith("ada_scale"):
            w = 1.0 + 0.1 * rs.standard_normal(shape)
        elif name.endswith(".weight") and len(shape) >= 2:
            bound = 1.0 / np.sqrt(np.prod(shape[1:]))
            w = rs.uniform(-bound, bound, shape)
        else:
            w = 0.05 * rs.standard_normal(shape)
        state[name] = torch.from_numpy(w.astype(np.float32))
    return state


def _ring_rows(C, wptr, sign):
    """(B, C) source rows: ring row p ← right-aligned row (p - wptr) mod C
    (sign -1), right-aligned row j ← ring row (wptr + j) mod C (sign 1)."""
    wptr = torch.as_tensor(np.asarray(wptr), dtype=torch.long).reshape(-1, 1)
    return (torch.arange(C)[None, :] + sign * wptr) % C


def _gather_rows(att, rows):
    att = torch.as_tensor(np.asarray(att, np.float32))
    if att.shape[-2] == 0:
        return att.clone()
    idx = rows[:, None, :, None].expand(*att.shape[:-4], -1, att.shape[-3],
                                        -1, att.shape[-1])
    return att.gather(-2, idx)


def ring_from_right_aligned(att, wptr):
    """masr_tpu's right-aligned cache (..., B, h, C, E) → the port's ring
    for per-slot write pointers wptr (B,). With wptr = 0 the two agree."""
    return _gather_rows(att, _ring_rows(np.shape(att)[-2], wptr, -1))


def right_aligned_from_ring(att, wptr):
    """The port's ring (..., B, h, C, E) with write pointers wptr (B,) →
    masr_tpu's right-aligned cache (the inverse of
    ring_from_right_aligned)."""
    return _gather_rows(att, _ring_rows(np.shape(att)[-2], wptr, 1))


def ring_from_mirrored(rings, d_k):
    """masr_tpu's mirrored engine rings, one (B, h, 2·C, rp) array per
    layer, → the port's (L, B, h, C, 2·d_k) ring with the same write
    pointers (rows [C, 2·C) duplicate rows [0, C); lanes past 2·d_k are
    padding)."""
    return torch.stack([
        torch.from_numpy(np.array(r, np.float32))[
            :, :, :np.shape(r)[2] // 2, :2 * d_k] for r in rings])


def mirrored_from_ring(att, lanes):
    """The port's (L, B, h, C, 2·d_k) ring → masr_tpu's mirrored rings, a
    tuple of L (B, h, 2·C, lanes) float32 numpy arrays."""
    att = np.asarray(torch.as_tensor(att).cpu(), np.float32)
    pad = [(0, 0)] * 3 + [(0, lanes - att.shape[-1])]
    return tuple(np.pad(np.concatenate([a, a], axis=2), pad) for a in att)
