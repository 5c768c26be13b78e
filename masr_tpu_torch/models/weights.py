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

An upstream state_dict loads through load_upstream_state_dict, which drops
what masr_tpu's converter drops (masr_tpu/models/convert.py:372-418): the
Efficient-Conformer stride layers' unused `concat_linear` and BatchNorm's
num_batches_tracked.

DeepSpeech2 has a map of its own (`_ds2_from_flax`, `_ds2_to_flax`), the
inverse of masr_tpu/models/convert.py:187-252 `convert_deepspeech2`:
upstream's fused gate rows are [i, f, g, o] (LSTM) and [r, z, n] (GRU);
flax's LSTM has its biases on the h-gates only (b_ih = 0, b_hh = flax's
h* biases; back, flax's = b_ih + b_hh); flax's GRU has biases on ir, iz,
in and hn (b_ir, b_iz, b_in = flax's ir, iz, in; b_hr = b_hz = 0; b_hn =
flax's hn; back, ir = b_ir + b_hr and iz = b_iz + b_hz); the first layer's
weight_ih columns are permuted between flax's f-major conv flatten and
upstream's c-major one. An upstream DS2 state_dict may nest the RNN one
level deeper (`rnns.{i}.rnn.rnn.`) and name the head `decoder.ctc_lo`, as
the converter accepts.

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


# ---------------------------------------------------------------------- #
# DeepSpeech2
# ---------------------------------------------------------------------- #
_LSTM_GATES, _GRU_GATES = "ifgo", "rzn"


def _is_ds2_flax(params):
    return "rnn_0" in params.get("encoder", {})


def _is_ds2_state(state_dict):
    return "encoder.rnns.0.rnn.weight_ih_l0" in state_dict


def _to_c_major(k, channels):
    """A first-layer flax input kernel (F'·C, H), f-major rows → the same
    rows c-major (C·F', H)."""
    H = k.shape[1]
    return np.transpose(k.reshape(-1, channels, H), (1, 0, 2)).reshape(-1, H)


def _to_f_major(k, channels):
    """The inverse of _to_c_major."""
    H = k.shape[1]
    return np.transpose(k.reshape(channels, -1, H), (1, 0, 2)).reshape(-1, H)


def _ds2_from_flax(params):
    """masr_tpu's DeepSpeech2 params → {upstream name: f32 ndarray}."""
    f32 = lambda a: np.asarray(a, np.float32)    # noqa: E731
    enc = params["encoder"]
    out = {}
    for i, conv in ((0, "conv1"), (2, "conv2")):
        out[f"encoder.conv.conv.{i}.weight"] = np.transpose(
            f32(enc["conv"][conv]["kernel"]), (3, 2, 0, 1))
        out[f"encoder.conv.conv.{i}.bias"] = f32(enc["conv"][conv]["bias"])
    channels = out["encoder.conv.conv.0.weight"].shape[0]
    i = 0
    while f"rnn_{i}" in enc:
        layer, base = enc[f"rnn_{i}"], f"encoder.rnns.{i}."
        for cell_name, rev in (("cell_fw", ""), ("cell_bw", "_reverse")):
            if cell_name not in layer:
                continue
            cell = layer[cell_name]
            gates = _LSTM_GATES if "ii" in cell else _GRU_GATES
            H = f32(cell["h" + gates[0]]["kernel"]).shape[0]
            w_ih = [f32(cell["i" + g]["kernel"]) for g in gates]
            if i == 0:
                w_ih = [_to_c_major(k, channels) for k in w_ih]
            rnn = base + "rnn."
            out[rnn + "weight_ih_l0" + rev] = np.concatenate(w_ih, 1).T
            out[rnn + "weight_hh_l0" + rev] = np.concatenate(
                [f32(cell["h" + g]["kernel"]) for g in gates], 1).T
            zero = np.zeros(H, np.float32)
            if gates == _LSTM_GATES:
                b_ih = [zero] * 4
                b_hh = [f32(cell["h" + g]["bias"]) for g in gates]
            else:
                b_ih = [f32(cell["i" + g]["bias"]) for g in gates]
                b_hh = [zero, zero, f32(cell["hn"]["bias"])]
            out[rnn + "bias_ih_l0" + rev] = np.concatenate(b_ih)
            out[rnn + "bias_hh_l0" + rev] = np.concatenate(b_hh)
        out[base + "layer_norm.weight"] = f32(layer["layer_norm"]["scale"])
        out[base + "layer_norm.bias"] = f32(layer["layer_norm"]["bias"])
        i += 1
    out["ctc.ctc_lo.weight"] = f32(params["ctc"]["ctc_lo"]["kernel"]).T
    out["ctc.ctc_lo.bias"] = f32(params["ctc"]["ctc_lo"]["bias"])
    return out


def _ds2_to_flax(state_dict):
    """{upstream name: tensor} of a DeepSpeech2 → masr_tpu's params tree
    of f32 ndarrays, in masr_tpu's module order."""
    sd = {k: v.detach().cpu().numpy().astype(np.float32)
          for k, v in state_dict.items()}
    conv = {}
    for i, name in ((0, "conv1"), (2, "conv2")):
        conv[name] = {
            "bias": sd[f"encoder.conv.conv.{i}.bias"],
            "kernel": np.ascontiguousarray(np.transpose(
                sd[f"encoder.conv.conv.{i}.weight"], (2, 3, 1, 0)))}
    channels = sd["encoder.conv.conv.0.weight"].shape[0]
    enc = {"conv": conv}
    i = 0
    while f"encoder.rnns.{i}.rnn.weight_ih_l0" in sd:
        base = f"encoder.rnns.{i}."
        layer = {}
        for cell_name, rev in (("cell_bw", "_reverse"), ("cell_fw", "")):
            rnn = base + "rnn."
            if rnn + "weight_ih_l0" + rev not in sd:
                continue
            w_ih, w_hh = (sd[rnn + f"weight_{w}_l0" + rev]
                          for w in ("ih", "hh"))
            b_ih, b_hh = (sd[rnn + f"bias_{w}_l0" + rev]
                          for w in ("ih", "hh"))
            H = w_hh.shape[1]
            gates = _LSTM_GATES if w_hh.shape[0] == 4 * H else _GRU_GATES
            cell = {}
            for j, g in enumerate(gates):
                rows = slice(j * H, (j + 1) * H)
                k_i = np.ascontiguousarray(w_ih[rows].T)
                if i == 0:
                    k_i = np.ascontiguousarray(_to_f_major(k_i, channels))
                k_h = np.ascontiguousarray(w_hh[rows].T)
                if gates == _LSTM_GATES:
                    cell["i" + g] = {"kernel": k_i}
                    cell["h" + g] = {"bias": b_ih[rows] + b_hh[rows],
                                     "kernel": k_h}
                elif g == "n":
                    cell["in"] = {"bias": b_ih[rows], "kernel": k_i}
                    cell["hn"] = {"bias": b_hh[rows], "kernel": k_h}
                else:
                    cell["i" + g] = {"bias": b_ih[rows] + b_hh[rows],
                                     "kernel": k_i}
                    cell["h" + g] = {"kernel": k_h}
            layer[cell_name] = dict(sorted(cell.items()))
        layer["layer_norm"] = {"bias": sd[base + "layer_norm.bias"],
                               "scale": sd[base + "layer_norm.weight"]}
        enc[f"rnn_{i}"] = layer
        i += 1
    return {"ctc": {"ctc_lo": {
        "bias": sd["ctc.ctc_lo.bias"],
        "kernel": np.ascontiguousarray(sd["ctc.ctc_lo.weight"].T)}},
        "encoder": enc}


def _ds2_upstream_names(state_dict):
    """Upstream DS2 names as masr_tpu's converter accepts them → the
    port's: `rnns.{i}.rnn.rnn.` → `rnns.{i}.rnn.`, `decoder.ctc_lo.` →
    `ctc.ctc_lo.`."""
    out = {}
    for k, v in state_dict.items():
        k = re.sub(r"^(encoder\.rnns\.\d+\.rnn\.)rnn\.", r"\1", k)
        out[re.sub(r"^decoder\.ctc_lo\.", "ctc.ctc_lo.", k)] = v
    return out


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
    if _is_ds2_flax(variables["params"]):
        return {k: torch.from_numpy(np.array(w, order="C")) for k, w in
                _ds2_from_flax(variables["params"]).items()}
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
    if _is_ds2_state(state_dict):
        return {"params": _ds2_to_flax(state_dict)}
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


def load_upstream_state_dict(model, state_dict):
    """Load an upstream MASR state_dict {name: tensor or array} into the
    port's `model` (upstream names are the port's): `.concat_linear.`
    entries and num_batches_tracked are dropped; every other entry must
    fit the model and every parameter and persistent buffer but
    num_batches_tracked must be given, or it raises; a DeepSpeech2's names
    are first read as masr_tpu's converter reads them. → model."""
    state = {k: torch.as_tensor(np.asarray(v, np.float32))
             for k, v in _ds2_upstream_names(state_dict).items()
             if ".concat_linear." not in k
             and not k.endswith("num_batches_tracked")}
    missing, unexpected = model.load_state_dict(state, strict=False)
    missing = [k for k in missing if not k.endswith("num_batches_tracked")]
    if missing or unexpected:
        raise RuntimeError(f"upstream weights do not fit the model: "
                           f"missing {missing}, unexpected {unexpected}")
    return model


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
# DeepSpeech2's fused gate matrices and biases (torch.nn.LSTM / GRU names)
_RNN_IH = re.compile(r"\.rnn\.weight_ih_l0(_reverse)?$")
_RNN_HH = re.compile(r"\.rnn\.weight_hh_l0(_reverse)?$")
_RNN_BIAS = re.compile(r"\.rnn\.bias_(ih|hh)_l0(_reverse)?$")


@torch.no_grad()
def flax_like_init(model, generator):
    """Re-initialise `model` in place with the distributions masr_tpu's
    flax modules start from (train_conf.init_type "flax"): kernels
    lecun_normal (a normal truncated at ±2σ, σ = 1/√fan_in / 0.8796), biases
    0, LayerNorm and BatchNorm scales and AdaptiveScale scales 1, the
    AdaptiveScale shifts 0, embeddings N(0, 1/d), pos_bias_u/v
    xavier_uniform, and DeepSpeech2's recurrent kernels orthogonal per
    gate (flax's OptimizedLSTMCell and GRUCell; their input kernels
    lecun_normal per gate, whose fan_in is the row length); drawn from
    `generator` (CPU)."""
    for name, p in model.named_parameters():
        t = torch.empty(p.shape, dtype=torch.float32)
        if _RNN_HH.search(name):
            H = p.shape[1]
            for g in range(p.shape[0] // H):
                torch.nn.init.orthogonal_(t[g * H:(g + 1) * H],
                                          generator=generator)
        elif _RNN_IH.search(name):
            std = (1.0 / np.sqrt(p.shape[1])) / 0.87962566103423978
            torch.nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std,
                                        generator=generator)
        elif name.endswith("pos_bias_u") or name.endswith("pos_bias_v"):
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


def _torch_default_redraw(tree, generator):
    """masr_tpu's torch_default_reinit rule (masr_tpu/models/
    initializers.py:38-69) over a flax 'params' tree, in place: a 'kernel'
    of ndim >= 2 U(±1/√fan_in), fan_in = prod(shape[:-1]); a 'bias' beside
    such a kernel U(±1/√fan_in) of that kernel; an 'embedding' N(0, 1);
    every other leaf as it is."""
    for key, leaf in list(tree.items()):
        if isinstance(leaf, dict):
            _torch_default_redraw(leaf, generator)
            continue
        kernel = tree.get("kernel")
        if key == "embedding" and leaf.ndim == 2:
            t = torch.empty(leaf.shape).normal_(0.0, 1.0, generator=generator)
        elif key == "kernel" and leaf.ndim >= 2 or (
                key == "bias" and isinstance(kernel, np.ndarray)
                and kernel.ndim >= 2):
            fan_in = int(np.prod((leaf if key == "kernel"
                                  else kernel).shape[:-1]))
            bound = 1.0 / np.sqrt(fan_in)
            t = torch.empty(leaf.shape).uniform_(-bound, bound,
                                                 generator=generator)
        else:
            continue
        tree[key] = t.numpy()


@torch.no_grad()
def torch_default_like_init(model, generator):
    """Re-initialise `model` in place as masr_tpu's train_conf.init_type
    "torch_default" starts it: its flax init (flax_like_init) with every
    kernel, every bias beside one and every embedding redrawn by
    torch_default_reinit's rule in the flax layout (so fan_in counts a
    conv's receptive field, pos_bias_u/v stay xavier_uniform, norms stay
    1 and 0, and DeepSpeech2's recurrent kernels draw U(±1/√fan_in) per
    gate matrix with the one bias flax's cells have); drawn from
    `generator` (CPU)."""
    flax_like_init(model, generator)
    variables = to_flax_variables(model.state_dict())
    _torch_default_redraw(variables["params"], generator)
    missing, unexpected = model.load_state_dict(
        from_flax_variables(variables), strict=False)
    missing = [k for k in missing if not k.endswith("num_batches_tracked")]
    if missing or unexpected:
        raise RuntimeError(f"the flax layout lost {missing} / {unexpected}")


def _lstm(model):
    """True for a DeepSpeech2 of LSTM layers."""
    return isinstance(model.encoder.rnns[0].rnn, torch.nn.LSTM)


def seeded_state_dict(model, seed):
    """Random weights for `model`, drawn with numpy from `seed`: weights
    U(±1/√fan_in) as torch's default init, norm and adaptive scales
    1 + N(0, 0.1²), BatchNorm running variances U(0.5, 1.5), biases, means
    and the other vectors N(0, 0.05²) (non-zero, so padding semantics
    show); BatchNorm's num_batches_tracked stays as it is. DeepSpeech2's
    gate matrices are U(±1/√H) as torch's RNN init, and the biases that
    flax's cells lack are 0 (an LSTM's bias_ih, a GRU's b_hr and b_hz), so
    that the state is one masr_tpu's tree holds exactly. → state_dict of
    tensors (f32 but for that counter)."""
    rs = np.random.RandomState(seed)
    state = {}
    for name, p in model.state_dict().items():
        shape = tuple(p.shape)
        if name.endswith("num_batches_tracked"):
            state[name] = p.clone()
            continue
        if _RNN_IH.search(name) or _RNN_HH.search(name):
            bound = 1.0 / np.sqrt(model.encoder.rnn_size)
            w = rs.uniform(-bound, bound, shape)
        elif _RNN_BIAS.search(name):
            w = 0.05 * rs.standard_normal(shape)
            kind = _RNN_BIAS.search(name).group(1)
            if _lstm(model) and kind == "ih":
                w[:] = 0.0
            elif not _lstm(model) and kind == "hh":
                w[: 2 * model.encoder.rnn_size] = 0.0
        elif name.endswith("running_var"):
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


def _state_tensor(a):
    """A cache array (torch, numpy or jax) → a CPU torch tensor: bf16 stays
    bf16 (the bf16 mode's caches), anything else becomes f32."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
        return a if a.dtype == torch.bfloat16 else a.float()
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(arr, np.float32))


def _gather_rows(att, rows):
    att = _state_tensor(att)
    if att.shape[-2] == 0:
        return att.clone()
    idx = rows[:, None, :, None].expand(*att.shape[:-4], -1, att.shape[-3],
                                        -1, att.shape[-1])
    return att.gather(-2, idx)


def ring_from_right_aligned(att, wptr):
    """masr_tpu's right-aligned cache (..., B, h, C, E) → the port's ring
    for per-slot write pointers wptr (B,). With wptr = 0 the two agree.
    These converters keep a bf16 cache bf16 (f32 otherwise)."""
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
        _state_tensor(r)[:, :, :np.shape(r)[2] // 2, :2 * d_k]
        for r in rings])


def mirrored_from_ring(att, lanes):
    """The port's (L, B, h, C, 2·d_k) ring → masr_tpu's mirrored rings, a
    tuple of L (B, h, 2·C, lanes) float32 numpy arrays (a bf16 ring's
    values exactly: cast them back to bf16 for a bf16 masr_tpu state)."""
    att = _state_tensor(att).float().numpy()
    pad = [(0, 0)] * 3 + [(0, lanes - att.shape[-1])]
    return tuple(np.pad(np.concatenate([a, a], axis=2), pad) for a in att)
