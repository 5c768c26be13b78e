"""bf16 training in the port (masr_tpu's train_conf.enable_amp): the bf16
modes of rows 3 and 7 (the training-layer kernels' plain twins), the
Conformer's and the layer_norm Squeezeformer's loss and grads, and
MASRTrainer with enable_amp, against masr_tpu at dtype=jnp.bfloat16 on the
CPU, at small widths (d 64, 4 heads, FFN 256, conv 7, B 3, T' = 40 with
padding; the Squeezeformer with reduce 1 / recover 2).

What each test holds the port against:
- rows 3 and 7: masr_tpu's Pallas training kernels at bf16 in interpret
  mode (fused_conformer_layer_train causal; fused_squeezeformer_layer_train
  non-causal at full rate and causal at half rate, the reduced rate's
  strided mask), output and every grad of a random bf16 cotangent;
- the models: jax.value_and_grad of masr_tpu's ConformerModel and
  SqueezeformerModel at dtype=bf16 (the other routes:
  tests/test_torch_amp_families.py). On the CPU masr_tpu trains those
  through its flax layers (its Pallas route needs a TPU), which round at
  every Dense where the kernel rounds only where it stores x's dtype.
Each masr_tpu function runs once, compiled by XLA with its backend
optimisation level 0 and without its expensive LLVM passes: the same
arithmetic at half the compile time of the interpret-mode kernels (their
compile dominates this file). The weights are drawn on the port's side
(seeded_state_dict for a layer, the flax-like init perturbed for a model)
and carried into masr_tpu's layout by models/weights.py, whose round trip
other tests hold: masr_tpu's own eager init of a layer took 5 s.

Tolerances (tests/test_torch_bf16_serving.py's rule, in bf16 roundings of
2^-8): `_bf16_close` allows a max abs error of n_max roundings of the
reference's largest value and a mean abs error of n_mean roundings of its
mean magnitude; the rows keep the rule's 8 and 1 for the output and every
grad, each grad measured against its own largest value. The models'
bound, `_MODEL_ROUNDINGS`, is explained where it is defined."""
import functools
import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import masr_tpu.models.conformer as jconf
import masr_tpu.models.squeezeformer as jsqm
import masr_tpu_torch.models.conformer as tconf
import masr_tpu_torch.models.squeezeformer as tsqm
from masr_tpu.models.registry import build_model as build_flax_model
from masr_tpu.ops.pallas import squeezeformer_layer as jsq
from masr_tpu.ops.pallas.conformer_layer import pack_layer_params as jpack
from masr_tpu.ops.pallas.conformer_layer_train import \
    fused_conformer_layer_train as pallas_row3
from masr_tpu.ops.pallas.squeezeformer_layer_train import \
    fused_squeezeformer_layer_train as pallas_row7
from masr_tpu_torch.models.conformer import ConformerEncoderLayer
from masr_tpu_torch.models.registry import build_model
from masr_tpu_torch.models.squeezeformer import SqueezeformerEncoderLayer
from masr_tpu_torch.models.weights import (flax_like_init,
                                           from_flax_variables,
                                           grads_to_flax_variables,
                                           seeded_state_dict,
                                           to_flax_variables)
from masr_tpu_torch.ops.cuda import conformer_layer_train as clt
from masr_tpu_torch.ops.cuda import squeezeformer_layer_train as sqt
from masr_tpu_torch.ops.cuda.conformer_layer import pack_layer_params
from masr_tpu_torch.ops.cuda.squeezeformer_layer import pack_sq_layer_params
from test_torch_threads import one_torch_thread  # noqa: F401

BF = torch.bfloat16
D, H, FF, K, B, T = 64, 4, 256, 7, 3, 40
LENS = [40, 31, 17]
CHUNK, LEFT = 8, 2
FEAT, VOCAB = 80, 20
# one XLA compile option set for every masr_tpu function here (the module
# docstring)
_FAST_XLA = {"xla_backend_optimization_level": 0,
             "xla_llvm_disable_expensive_passes": True}


def _compiled(fn, *args):
    return jax.jit(fn).lower(*args).compile(compiler_options=_FAST_XLA)


def _f32(a):
    """torch (any dtype) or jax/numpy → numpy f32 (bf16 values exactly)."""
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _tb(a):
    """jax/numpy → torch bf16 (a bf16 array exactly)."""
    return torch.from_numpy(_f32(a)).to(BF)


def _roundings(got, want):
    """(max |got - want| in roundings of max |want|, mean |got - want| in
    roundings of mean |want|)."""
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want)
    return (float(err.max()) / (2 ** -8 * max(float(np.abs(want).max()),
                                              1e-30)),
            float(err.mean()) / (2 ** -8 * max(float(np.abs(want).mean()),
                                               1e-30)))


def _bf16_close(got, want, n_max=8, n_mean=1, what=""):
    worst, mean = _roundings(got, want)
    assert worst <= n_max and mean <= n_mean, (what, worst, mean)


def _perturb(variables, seed, scale=0.05):
    """Every leaf moved off its init: ones (scales) by +|N|·scale, the rest
    by N·scale."""
    rs = np.random.RandomState(seed)
    leaves, treedef = jax.tree.flatten(variables)
    return jax.tree.unflatten(treedef, [
        (np.asarray(l) + (np.abs(rs.standard_normal(l.shape))
                          if l.size and float(np.min(l)) >= 0.9
                          else rs.standard_normal(l.shape)) * scale
         ).astype(np.float32) for l in leaves])


def _chunk_mask(T, lens):
    """(B, T, T) bool: dynamic-chunk (own chunk and LEFT earlier) & key <
    len."""
    r = np.arange(T)
    q, k = r[:, None] // CHUNK, r[None, :] // CHUNK
    return ((k <= q) & (k >= q - LEFT))[None] & \
        (r[None, None, :] < np.asarray(lens)[:, None, None])


# --------------------------------------------------------------------------- #
# rows 3 and 7: the twins' bf16 modes against the Pallas kernels at bf16
# --------------------------------------------------------------------------- #
def _row_case(rs, T, lens, pack, posp_w):
    """bf16 x, posp (a bf16 product of positions, as masr_tpu forms it),
    the cotangent and the mask."""
    bf = jnp.bfloat16
    x = jnp.asarray(rs.standard_normal((B, T, D)).astype(np.float32)).astype(
        bf)
    pos = jnp.asarray(rs.standard_normal((T, D)).astype(np.float32))
    posp = jnp.einsum("td,de->te", pos.astype(bf), posp_w,
                      preferred_element_type=jnp.float32).astype(bf)
    dy = jnp.asarray(rs.standard_normal((B, T, D)).astype(np.float32)).astype(
        bf)
    pack["posp"] = posp[None]
    return x, posp, dy, _chunk_mask(T, lens)


def _pallas_vjp(kernel, x, pack, dy):
    def run(xx, p, d):
        y, vjp = jax.vjp(lambda a, b: kernel(a, b), xx, p)
        return y, vjp(d)
    return _compiled(run, x, pack, dy)(x, pack, dy)


def _seeded(layer, seed):
    """layer with seeded_state_dict's weights (every bias and scale off its
    init) and masr_tpu's variables of the same layer (the weight map)."""
    layer.load_state_dict(seeded_state_dict(layer, seed))
    state = {"encoder.encoders.0." + k: t
             for k, t in layer.state_dict().items()}
    if isinstance(layer, SqueezeformerEncoderLayer):
        # the key by which the weight map tells a Squeezeformer
        state["encoder.preln.weight"] = torch.ones(D)
    v = to_flax_variables(state)
    return layer, {k: t["encoder"]["layer_0"] for k, t in v.items()}


def _port_grads(fn, x, posp, packed, dy):
    """The twin through autograd: → (y, dx, dposp, {key: grad})."""
    packed = {k: t.detach().clone().requires_grad_(True)
              for k, t in packed.items()}
    xt, pt = _tb(x).requires_grad_(True), _tb(posp).requires_grad_(True)
    y = fn(xt, pt, packed)
    assert y.dtype == BF
    y.backward(_tb(dy))
    return y, xt.grad, pt.grad, {k: t.grad for k, t in packed.items()}


def test_row3_bf16_twin_matches_pallas():
    """fused_conformer_layer_train's bf16 mode (the twin on CPU tensors, a
    causal layer, the port's bf16 pack) == masr_tpu's Pallas kernel at bf16
    (interpret mode): the output and dx, dposp and every packed array's
    grad within 8 roundings max and 1 mean, dropout 0."""
    causal = True
    rs = np.random.RandomState(1)
    layer, v = _seeded(ConformerEncoderLayer(D, H, FF, cnn_module_kernel=K,
                                             causal=causal), 1)
    pj = jpack(v["params"], jnp.bfloat16)
    x, posp, dy, mask = _row_case(rs, T, LENS, pj, pj.pop("linear_pos"))
    lens = jnp.asarray(LENS, jnp.int32)
    y, (dx, dp) = _pallas_vjp(
        lambda a, b: pallas_row3(a, jnp.asarray(mask), jnp.zeros(B, jnp.int32),
                                 lens, b, H, K, causal, 0.5, 1e-5, 0.0, 0.0,
                                 True, True), x, pj, dy)

    def run(xt, pt, packed):
        return clt.fused_conformer_layer_train(
            xt, torch.from_numpy(mask), torch.zeros(B, dtype=torch.int32),
            torch.tensor(LENS, dtype=torch.int32), pt, packed, layer=0,
            n_head=H, ksize=K, causal=causal)

    yt, dxt, dpt, grads = _port_grads(run, x, posp,
                                      pack_layer_params(layer, BF), dy)
    _bf16_close(yt, y, what="y")
    _bf16_close(dxt, dx, what="dx")
    _bf16_close(dpt, dp["posp"][0], what="dposp")
    assert grads["ffw1"].dtype == BF and grads["lnw"].dtype == torch.float32
    for k, g in grads.items():
        _bf16_close(g, dp[k], what=k)


# masr_tpu's Squeezeformer pack keys → the port's (vecb gathers attb, the
# two FFN output biases, the depthwise and pw2 biases)
_SQ_KEYS = {"lnw": "lnw", "ada": "adaw", "cnw": "cnw", "attw": "attw",
            "posb": "posb", "ffw1": "ffw1", "ffb1": "ffb1", "ffw2": "ffw2",
            "pw1w": "pw1w", "pw1b": "pw1b", "pw2w": "pw2w", "dww": "dww"}


def _sq_vecb(p):
    return jnp.concatenate([p["attb"], p["ffb2"], p["dwb"].reshape(1, D),
                            p["pw2b"].reshape(1, D)])


@pytest.mark.parametrize("causal,rate", [(False, "full"), (True, "half")])
def test_row7_bf16_twin_matches_pallas(causal, rate):
    """fused_squeezeformer_layer_train's bf16 mode (the twin, the unfolded
    bf16 pack: the adaptive scales applied in f32 before each product,
    their grads from the layer) == masr_tpu's Pallas kernel at bf16
    (interpret mode), at full rate and at half rate (T' 40 → 20 rows under
    the strided mask [:, ::2, ::2], the lengths halved rounding up): the
    output and every grad within 8 roundings max and 1 mean, dropout 0."""
    rs = np.random.RandomState(2)
    port, v = _seeded(SqueezeformerEncoderLayer(D, H, FF, K, "layer_norm",
                                                causal), 2)
    pj = jsq.pack_sq_layer_params(v["params"], None, jnp.bfloat16,
                                  conv_ln=True)
    lens_full = np.asarray(LENS)
    if rate == "half":
        Tr, lens_r = T // 2, (lens_full + 1) // 2
    else:
        Tr, lens_r = T, lens_full
    x, posp, dy, mask = _row_case(rs, Tr, lens_r, pj, pj.pop("linear_pos"))
    if rate == "half":
        mask = _chunk_mask(T, lens_full)[:, ::2, ::2]
    y, (dx, dp) = _pallas_vjp(
        lambda a, b: pallas_row7(a, jnp.asarray(mask), jnp.zeros(B, jnp.int32),
                                 jnp.asarray(lens_r, jnp.int32), b, H, K,
                                 causal, 1e-6, 1e-5, 0.0, 0.0, True, True),
        x, pj, dy)

    def run(xt, pt, packed):
        return sqt.fused_squeezeformer_layer_train(
            xt, torch.from_numpy(mask), torch.zeros(B, dtype=torch.int32),
            torch.tensor(lens_r, dtype=torch.int32), pt, packed, layer=0,
            n_head=H, ksize=K, causal=causal)

    yt, dxt, dpt, grads = _port_grads(run, x, posp,
                                      pack_sq_layer_params(port, BF), dy)
    _bf16_close(yt, y, what="y")
    _bf16_close(dxt, dx, what="dx")
    _bf16_close(dpt, dp["posp"][0], what="dposp")
    assert tuple(grads["ada"].shape) == (4, 2, D)
    for k, jk in _SQ_KEYS.items():
        _bf16_close(grads[k], dp[jk], what=k)
    _bf16_close(grads["vecb"], _sq_vecb(dp), what="vecb")


# --------------------------------------------------------------------------- #
# the models: loss and every grad against masr_tpu at dtype=bf16
# --------------------------------------------------------------------------- #
ENCS = {
    "conformer": dict(output_size=D, attention_heads=H, linear_units=FF,
                      num_blocks=2, cnn_module_kernel=K, causal=True,
                      use_dynamic_chunk=True, dropout_rate=0.0,
                      positional_dropout_rate=0.0,
                      attention_dropout_rate=0.0),
    "squeezeformer": dict(encoder_dim=D, output_size=D, attention_heads=H,
                          num_blocks=3, reduce_idx=1, recover_idx=2,
                          feed_forward_expansion_factor=FF // D,
                          cnn_module_kernel=K, cnn_norm_type="layer_norm",
                          dropout=0.0, input_dropout_rate=0.0,
                          attention_dropout_rate=0.0,
                          feed_forward_dropout_rate=0.0)}
DEC = dict(attention_heads=H, linear_units=FF, num_blocks=1, r_num_blocks=1,
           dropout_rate=0.0, positional_dropout_rate=0.0)
MODEL_CONF = dict(ctc_weight=0.3, lsm_weight=0.1, reverse_weight=0.3)
# A whole model's grads against masr_tpu's bf16 flax model. On the CPU
# masr_tpu trains through its flax layers, which round at every Dense (q, k,
# v, the FFN hidden rows, the attention output, the conv module's rows),
# where the kernel keeps f32 between its products and rounds only where
# masr_tpu's own kernel stores x's dtype; so a grad may stray from flax's
# about as far as flax's bf16 grads stray from f32. The rule, per
# parameter grad, in roundings as `_roundings` counts them: the port's
# bf16 grad is within twice flax's own bf16-vs-f32 distance plus
# _MODEL_ROUNDINGS (max, mean) of masr_tpu's bf16 grad. The f32 grads are
# the port's (tests/test_torch_training.py and test_torch_sq_training.py
# hold them to masr_tpu's within 1e-4). Left out: the attention key
# biases, whose true grad is 0 (a softmax ignores a shift shared by a
# query's scores), so that both packages' values are rounding noise.
# Measured on the CPU over seeds 1-8 of `_model_case`, both families: the
# loss within 0.79 roundings; the grads' largest excess over twice flax's
# move 26.1 roundings (max) and 7.5 (mean), both in the decoder (the
# Conformer at seed 1: the right decoder's FFN w_1, whose grads pass the
# ReLU's derivative, which flips where a pre-activation within a rounding
# of 0 takes the other side; its norm3), elsewhere at most 19.2 and 3.0.
# Held to 28 and 8. The second rule is the issue's: the port's bf16 grads
# (mean error over mean magnitude, averaged over the grads) no further from
# its f32 grads than twice masr_tpu's bf16 grads are; over seeds 1-8 the
# ratio was 0.63-1.37.
_MODEL_ROUNDINGS = (28, 8)


@pytest.fixture
def fixed_chunk(monkeypatch):
    """Both packages' dynamic chunk, drawn from their own generators, fixed
    to CHUNK frames with LEFT left chunks; the Squeezeformer subsampling's
    positional dropout, 0.1 in masr_tpu whatever its config, set to 0 in
    both."""
    def fixed(orig):
        def mask(xs_len, masks, dyn, dyn_left, dcs, scs, left, *a, **kw):
            return orig(xs_len, masks, dyn, dyn_left,
                        CHUNK if dyn and dcs == 0 else dcs, scs,
                        LEFT if dyn and dcs == 0 else left)
        return mask

    for mod in (jconf, tconf, jsqm, tsqm):
        monkeypatch.setattr(mod, "add_optional_chunk_mask",
                            fixed(mod.add_optional_chunk_mask))
    monkeypatch.setattr(jsqm, "DepthwiseConv2dSubsampling4",
                        functools.partial(jsqm.DepthwiseConv2dSubsampling4,
                                          pos_dropout_rate=0.0))
    port_sub = tsqm.DepthwiseConv2dSubsampling4

    def port_fixed(*args, **kwargs):
        m = port_sub(*args, **kwargs)
        m.pos_enc.dropout_rate = 0.0
        return m

    monkeypatch.setattr(tsqm, "DepthwiseConv2dSubsampling4", port_fixed)


def _model_case(family, seed):
    """The port's flax-like init of the model, every leaf perturbed, in
    masr_tpu's layout (the weight map, models/weights.py), and a batch (B
    3, 167 frames: T' = 41 after the subsampling, 21 after the reduction;
    ragged)."""
    rs = np.random.RandomState(seed)
    speech = rs.standard_normal((B, 167, FEAT)).astype(np.float32)
    lens = np.asarray([167, 140, 100], np.int32)
    text = rs.randint(1, VOCAB - 1, (B, 6)).astype(np.int32)
    tlens = np.asarray([6, 4, 3], np.int32)
    text[1, 4:] = -1
    text[2, 3:] = -1
    args = [jnp.asarray(a) for a in (speech, lens, text, tlens)]
    port = build_model(family, FEAT, VOCAB, streaming=family == "conformer",
                       encoder_conf=ENCS[family], decoder_conf=DEC,
                       model_conf=MODEL_CONF)
    flax_like_init(port, torch.Generator().manual_seed(seed))
    return _perturb(to_flax_variables(port.state_dict()), seed)["params"], \
        args


def _masr_tpu_loss_and_grads(family, params, args, dtype):
    """jax.value_and_grad of masr_tpu's model at dtype → (loss, grads)."""
    fm = build_flax_model(family, FEAT, VOCAB, streaming=family ==
                          "conformer", encoder_conf=ENCS[family],
                          decoder_conf=DEC, model_conf=MODEL_CONF,
                          dtype=dtype)

    def loss(p, *a):
        out = fm.apply({"params": p}, *a, train=True,
                       rngs={"dropout": jax.random.PRNGKey(1),
                             "chunk": jax.random.PRNGKey(2)})
        return out["loss"]

    fn = jax.value_and_grad(loss)
    return _compiled(fn, params, *args)(params, *args)


def _port_loss_and_grads(family, params, args, dtype):
    port = build_model(family, FEAT, VOCAB, streaming=family == "conformer",
                       encoder_conf=ENCS[family], decoder_conf=DEC,
                       model_conf=MODEL_CONF, dtype=dtype)
    missing, unexpected = port.load_state_dict(
        from_flax_variables({"params": params}), strict=False)
    assert not missing and not unexpected
    speech, lens, text, tlens = (torch.from_numpy(np.asarray(a))
                                 for a in args)
    out = port.train()(speech, lens.long(), text.long(), tlens.long(),
                       generator=torch.Generator().manual_seed(5),
                       chunk_generator=torch.Generator().manual_seed(6))
    out["loss"].backward()
    grads = grads_to_flax_variables(port.named_parameters())["params"]
    return float(out["loss"].detach()), grads


def _leaves(tree, like):
    """tree's leaves in the order of like's paths."""
    out = []
    for path, _ in jax.tree_util.tree_flatten_with_path(like)[0]:
        node = tree
        for k in path:
            node = node[k.key]
        out.append(node)
    return out


def _mean_rel(got, want):
    """Mean abs error over the mean magnitude, over every grad array."""
    return float(np.mean([np.abs(_f32(g) - _f32(w)).mean()
                          / max(float(np.abs(_f32(w)).mean()), 1e-30)
                          for g, w in zip(got, want)]))


def _model_distances(family, seed):
    """→ (loss roundings, [(grad path, port vs masr_tpu (max, mean),
    masr_tpu bf16 vs f32 (max, mean))] without the key biases, the port's
    bf16-vs-f32 mean distance, masr_tpu's)."""
    params, args = _model_case(family, seed)
    jl, jg = _masr_tpu_loss_and_grads(family, params, args, jnp.bfloat16)
    tl, tg = _port_loss_and_grads(family, params, args, BF)
    _, tg32 = _port_loss_and_grads(family, params, args, torch.float32)
    paths = [jax.tree_util.keystr(p)
             for p, _ in jax.tree_util.tree_flatten_with_path(jg)[0]]
    keep = [i for i, p in enumerate(paths)
            if not ("linear_k" in p and "bias" in p)]
    want = [jax.tree.leaves(jg)[i] for i in keep]
    got = [_leaves(tg, jg)[i] for i in keep]
    f32 = [_leaves(tg32, jg)[i] for i in keep]
    loss_err = abs(tl - float(jl)) / (2 ** -8 * abs(float(jl)))
    rows = [(paths[i], _roundings(g, w), _roundings(w, r))
            for i, g, w, r in zip(keep, got, want, f32)]
    return loss_err, rows, _mean_rel(got, f32), _mean_rel(want, f32)


@pytest.mark.parametrize("family", list(ENCS))
def test_bf16_model_loss_and_grads_match_masr_tpu(fixed_chunk, family):
    """The bf16 model's hybrid loss and every parameter grad (f32, as the
    parameters) against jax.value_and_grad of masr_tpu's model at
    dtype=bf16 (seed 1): the loss within one rounding, each grad within
    the rule at `_MODEL_ROUNDINGS`; and the port's bf16 grads no further
    from its f32 grads than twice masr_tpu's bf16 grads are."""
    loss_err, rows, port_dist, ref_dist = _model_distances(family, 1)
    assert loss_err <= 1, loss_err
    n_max, n_mean = _MODEL_ROUNDINGS
    for path, (e_max, e_mean), (r_max, r_mean) in rows:
        assert e_max <= 2 * r_max + n_max, (path, e_max, r_max)
        assert e_mean <= 2 * r_mean + n_mean, (path, e_mean, r_mean)
    assert port_dist <= 2 * ref_dist, (port_dist, ref_dist)


# --------------------------------------------------------------------------- #
# MASRTrainer with enable_amp
# --------------------------------------------------------------------------- #
CHARS = list("上家音月火少风大你下雪蓝右黑真")
PRE = dict(feature_method="fbank", n_mels=80, sample_rate=16000,
           use_dB_normalization=True, target_dB=-20)


def _corpus(root, n_train=8, n_test=4):
    """Synthetic speech with manifests, a vocabulary and CMVN statistics
    in the layout create_data writes → paths dict."""
    from masr_tpu_torch.audio.io import write_wave
    from masr_tpu_torch.audio.synth_tts import SyntheticTTS
    tts = SyntheticTTS(sample_rate=16000)
    rs = np.random.RandomState(7)
    os.makedirs(root, exist_ok=True)
    paths = {}
    for split, n in (("train", n_train), ("test", n_test)):
        lines = []
        for i in range(n):
            text = "".join(CHARS[j] for j in rs.randint(0, len(CHARS),
                                                         2 + i % 3))
            wav = tts.render(text, spk_id=i % 3)
            path = os.path.join(root, f"{split}_{i}.wav")
            write_wave(path, wav, 16000)
            lines.append(json.dumps({"audio_filepath": path,
                                     "duration": len(wav) / 16000,
                                     "text": text}, ensure_ascii=False))
        paths[split] = os.path.join(root, f"manifest.{split}")
        with open(paths[split], "w", encoding="utf-8") as f:
            f.write("\n".join(sorted(
                lines, key=lambda l: json.loads(l)["duration"])) + "\n")
    paths["vocab"] = os.path.join(root, "vocabulary.txt")
    with open(paths["vocab"], "w", encoding="utf-8") as f:
        f.writelines(t + "\n" for t in ["<blank>", "<unk>", *CHARS, "<eos>"])
    paths["cmvn"] = os.path.join(root, "mean_istd.json")
    with open(paths["cmvn"], "w", encoding="utf-8") as f:
        json.dump({"mean": [10.0] * 80, "istd": [0.3] * 80}, f)
    return paths


def _amp_config(corpus, save_dir, max_epoch, family="conformer", enc=None):
    return {
        "encoder_conf": enc or dict(output_size=32, attention_heads=2,
                                    linear_units=48, num_blocks=2,
                                    cnn_module_kernel=7, dropout_rate=0.1,
                                    positional_dropout_rate=0.1,
                                    attention_dropout_rate=0.1),
        "decoder_conf": dict(attention_heads=2, linear_units=32,
                             num_blocks=1, r_num_blocks=1),
        "model_conf": dict(ctc_weight=0.3, lsm_weight=0.1,
                           reverse_weight=0.3),
        "dataset_conf": dict(batch_size=4, num_workers=2, min_duration=0,
                             max_duration=20,
                             train_manifest=corpus["train"],
                             test_manifest=corpus["test"],
                             dataset_vocab=corpus["vocab"],
                             mean_istd_path=corpus["cmvn"]),
        "preprocess_conf": PRE,
        "optimizer_conf": dict(optimizer="Adam", weight_decay=1e-6,
                               learning_rate=4e-3, scheduler="WarmupLR",
                               scheduler_conf=dict(warmup_steps=2,
                                                   min_lr=1e-5)),
        "train_conf": dict(grad_clip=5.0, accum_grad=1, max_epoch=max_epoch,
                           log_interval=1, enable_amp=True),
        "use_model": family, "streaming": True,
        "metrics_type": "cer", "log_dir": os.path.join(save_dir, "log")}


def test_trainer_enable_amp_trains_resumes_evaluates_exports(tmp_path):
    """MASRTrainer(device="cpu") with train_conf.enable_amp: the model
    computes in bf16 with f32 parameters; 3 epochs of 2 steps on synthetic
    speech, the loss finite and falling (the last epoch's mean below the
    first step's); a 4th epoch resumes from last_model (8 steps);
    `evaluate` decodes the bf16 model; `export` writes the f32 parameters,
    and the bundle, loaded with dtype=bf16, gives the trained bf16 model's
    CTC probabilities exactly."""
    from masr_tpu_torch.infer.inference_model import InferencePredictor
    from masr_tpu_torch.training.trainer import MASRTrainer
    corpus = _corpus(str(tmp_path / "corpus"))
    save = str(tmp_path / "models")
    tr = MASRTrainer(_amp_config(corpus, str(tmp_path), 3), device="cpu")
    tr.train(save_model_path=save, augment_conf_path=None)
    model = tr.model
    assert model.encoder.compute_dtype == BF
    assert all(p.dtype == torch.float32 for p in model.parameters())
    with open(os.path.join(str(tmp_path), "log", "scalars.jsonl")) as f:
        points = [json.loads(l) for l in f]
    losses = [p["value"] for p in points if p["tag"] == "Train/Loss"]
    assert len(losses) == 6 and np.isfinite(losses).all(), losses
    assert np.mean(losses[4:]) < losses[0], losses
    run = os.path.join(save, "conformer_streaming_fbank")
    tr2 = MASRTrainer(_amp_config(corpus, str(tmp_path), 4), device="cpu")
    tr2.train(save_model_path=save, augment_conf_path=None)
    assert tr2.state.step == 8
    err, loss = tr2.evaluate(resume_model=os.path.join(run, "last_model"))
    assert 0.0 <= err and np.isfinite(loss)
    bundle = tr2.export(save_model_path=save,
                        resume_model=os.path.join(run, "last_model"))
    pred = InferencePredictor(bundle, dtype=BF, device="cpu")
    feats = torch.randn(1, 120, FEAT)
    lens = torch.tensor([120])
    with torch.no_grad():
        want, _ = tr2.model.eval().get_encoder_out(feats, lens)
        got, _ = pred.model.get_encoder_out(feats, lens)
    assert want.dtype == torch.float32
    assert torch.equal(got, want)


@pytest.mark.parametrize("family,enc,what", [
    ("squeezeformer", dict(encoder_dim=32, output_size=32, attention_heads=2,
                           num_blocks=3, reduce_idx=1, recover_idx=2,
                           feed_forward_expansion_factor=2,
                           cnn_module_kernel=7, cnn_norm_type="batch_norm"),
     "BatchNorm Squeezeformer"),
    ("efficient_conformer", dict(output_size=32, attention_heads=2,
                                 linear_units=48, num_blocks=3,
                                 cnn_module_kernel=15,
                                 cnn_module_norm="layer_norm",
                                 efficient_conf=dict(stride_layer_idx=[1],
                                                     stride=[2],
                                                     group_layer_idx=[0, 1],
                                                     group_size=3)),
     "Efficient-Conformer"),
    ("deepspeech2", dict(num_rnn_layers=2, rnn_size=32), "DeepSpeech2")])
def test_trainer_enable_amp_builds_and_steps(tmp_path, family, enc, what):
    """enable_amp of the BatchNorm Squeezeformer, the Efficient-Conformer
    and DeepSpeech2 builds in MASRTrainer (the model at bf16, its
    parameters f32) and takes one CPU train step on a seeded batch: a
    finite f32 loss, and the parameters moved (accum_grad 1)."""
    from masr_tpu_torch.training.train_state import batch_to, train_step
    from masr_tpu_torch.training.trainer import MASRTrainer
    corpus = {k: str(tmp_path / k) for k in ("train", "test", "vocab")}
    corpus["cmvn"] = str(tmp_path / "mean_istd.json")
    with open(corpus["cmvn"], "w", encoding="utf-8") as f:
        json.dump({"mean": [10.0] * FEAT, "istd": [0.3] * FEAT}, f)
    conf = _amp_config(corpus, str(tmp_path), 1, family, enc)
    if family == "deepspeech2":
        conf["decoder_conf"], conf["model_conf"] = {}, {}
    tr = MASRTrainer(conf, device="cpu")
    model = tr._setup_model(FEAT, VOCAB)
    assert model.encoder.compute_dtype == BF, what
    assert all(p.dtype == torch.float32 for p in model.parameters())
    before = [p.detach().clone() for p in model.parameters()]
    rs = np.random.RandomState(4)
    batch = {"inputs": 10 + rs.standard_normal((2, 80, FEAT)).astype(
                 np.float32),
             "input_lens": np.asarray([80, 57], np.int32),
             "labels": np.asarray([[3, 4, 5], [6, 7, -1]], np.int32),
             "label_lens": np.asarray([3, 2], np.int32)}
    metrics = train_step(tr.state, batch_to(batch, "cpu"), 0)
    assert metrics["finite"] and np.isfinite(metrics["loss"]), metrics
    assert tr.state.updates == 1
    assert any(not torch.equal(a, p) for a, p in zip(before,
                                                      model.parameters()))
