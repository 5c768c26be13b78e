"""The port's Efficient-Conformer (masr_tpu_torch/models/efficient_conformer.py)
against masr_tpu's flax modules, on the CPU, at the sizes of
tests/test_fused_eff_tail.py: D=64, 2 heads, FFN 96, 4 blocks, the stride
layer at 1 (stride 2), grouped layers 0 and 1 (g=3), conv kernel 15 before
the stride and 7 after it (stride_kernel), every parameter perturbed away
from its init, inputs from a numpy seed.

Tolerances, f32 on the CPU in another sum order:
- modules (grouped attention, strided conv module, stride layer): atol
  1e-5 (rows of magnitude ~1-4);
- the encoder at full context, causal and not: atol 1e-5 (the tail
  through the full-context layer kernel's plain twin, against masr_tpu's
  all-XLA encoder: FORCE_ON_CPU is left alone);
- CTC probs of a bundle: atol 3e-5 (the bundle's CTC head is x8, which
  multiplies the logits' differences by 8, as in
  tests/test_torch_squeezeformer.py);
- chained and batched chunk steps: outputs and every cache atol 1e-5,
  offsets and cache lengths exactly;
- texts of predict, predict_batch, predict_stream, the engine and the
  server behind max_streams: equal.
The non-causal chunk step of the Conformer is held against masr_tpu here
too. The loss and grads are in tests/test_torch_eff_training.py.
"""
import os

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from masr_tpu.models.attention import cache_key_mask as jax_cache_key_mask
from masr_tpu.models.cmvn import GlobalCMVN as FlaxCMVN
from masr_tpu.models import efficient_conformer as je
from masr_tpu_torch.models import attention as pa
from masr_tpu_torch.models import efficient_conformer as pe
from masr_tpu_torch.models.attention import cache_key_mask
from masr_tpu_torch.models.cmvn import GlobalCMVN
from masr_tpu_torch.models.weights import from_flax_variables
from test_torch_threads import one_torch_thread  # noqa: F401

D, H, FF = 64, 2, 96
FEAT = 80
EFF = dict(stride_layer_idx=[1], stride=[2], group_layer_idx=[0, 1],
           group_size=3)
ENC = dict(output_size=D, attention_heads=H, linear_units=FF, num_blocks=4,
           cnn_module_kernel=15, cnn_module_norm="layer_norm",
           efficient_conf=EFF)
NO_DROP = dict(dropout_rate=0.0, attention_dropout_rate=0.0,
               positional_dropout_rate=0.0)
DEC = dict(attention_heads=2, linear_units=32, num_blocks=1, r_num_blocks=0)
VOCAB = ["<blank>", "<unk>", "你", "好", "天", "<space>", "<eos>"]
WIN, CH = 67, 16                     # a feature window and its chunk
PIECE = 3200                         # 0.2 s at 16 kHz


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _close(got, want, tol=1e-5):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=tol)


def _perturb(variables, seed, scale=0.05):
    """Every leaf moved off its init: ones (scales) by +|N|·scale, the
    rest by N·scale."""
    rs = np.random.RandomState(seed)
    leaves, treedef = jax.tree.flatten(variables)
    return jax.tree.unflatten(treedef, [
        (np.asarray(l) + (np.abs(rs.standard_normal(l.shape))
                          if l.size and float(np.min(l)) >= 0.9
                          else rs.standard_normal(l.shape)) * scale
         ).astype(np.float32) for l in leaves])


def _load(module, variables, prefix):
    sd = {k[len(prefix):]: v for k, v in from_flax_variables(variables).items()
          if k.startswith(prefix)}
    missing, unexpected = module.load_state_dict(sd, strict=False)
    assert not unexpected
    assert all(k.endswith("num_batches_tracked") for k in missing), missing
    return module.eval()


def _in_layer(v, *path):
    """Flax variables of a submodule, re-rooted at encoder.layer_0.path."""
    def wrap(t):
        for name in reversed(("encoder", "layer_0") + path):
            t = {name: t}
        return t
    return {k: wrap(t) for k, t in v.items()}


# --------------------------------------------------------------------------- #
# modules
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("cached", [False, True], ids=["full", "cache"])
def test_grouped_attention_matches_flax(cached):
    """T=23 (not a multiple of g), B=3. Full: a padded (B, 1, T) mask and
    a (B, T, T) chunk mask. Cache: C=10 right-aligned rows (7, 0 and 10
    valid) and a chunk of 8, masr_tpu's cache_key_mask: output and new
    cache atol 1e-5."""
    rs = np.random.RandomState(1)
    B, T, C = 3, (8 if cached else 23), 10
    attn = je.GroupedRelPositionMultiHeadedAttention(H, D, 0.0, group_size=3)
    x = rs.standard_normal((B, T, D)).astype(np.float32)
    T2 = C + T if cached else T
    pos = rs.standard_normal((1, T2, D)).astype(np.float32)
    v = _perturb(attn.init(jax.random.PRNGKey(0), jnp.asarray(x),
                           jnp.asarray(x), jnp.asarray(x),
                           jnp.ones((B, 1, T), bool), jnp.asarray(pos[:, :T])),
                 1)
    port = _load(pe.GroupedRelPositionMultiHeadedAttention(H, D, 0.0, 3),
                 _in_layer(v, "self_attn"), "encoder.encoders.0.self_attn.")
    assert tuple(port.pos_bias_u.shape) == (H, 3 * D // H)
    if cached:
        cache = rs.standard_normal((B, H, C, D // H * 2)).astype(np.float32)
        masks = [np.asarray(jax_cache_key_mask(C, T, n, 1))[0]
                 for n in (7, 0, 10)]
        mask = np.stack(masks)
        for n, m in zip((7, 0, 10), masks):
            np.testing.assert_array_equal(
                cache_key_mask(C, T, n, 1).numpy()[0], m)
        want, want_c = attn.apply(v, *(jnp.asarray(x),) * 3,
                                  jnp.asarray(mask), jnp.asarray(pos),
                                  (jnp.asarray(cache), 0))
        with torch.no_grad():
            got, got_c = port(_t(x), torch.from_numpy(mask), _t(pos),
                              _t(cache))
        _close(got_c, want_c)
        _close(got, want)
        return
    lens = np.asarray([23, 17, 5])
    pad = np.arange(T)[None, None, :] < lens[:, None, None]
    chunk = pad & (np.arange(T)[None, None, :]
                   < (np.arange(T)[None, :, None] // 4 + 1) * 4)
    for mask in (pad, chunk):
        want, _ = attn.apply(v, *(jnp.asarray(x),) * 3, jnp.asarray(mask),
                             jnp.asarray(pos))
        with torch.no_grad():
            got, none = port(_t(x), torch.from_numpy(mask), _t(pos))
        assert none is None
        _close(got, want)


def _flax_stride_layer(causal, seed):
    layer = je.StrideConformerEncoderLayer(
        size=D, attention_heads=H, linear_units=FF, dropout_rate=0.0,
        cnn_module_kernel=15, cnn_module_norm="layer_norm", causal=causal,
        stride=2, grouped=True, group_size=3)
    x = jnp.zeros((1, 9, D))
    m = jnp.ones((1, 1, 9), bool)
    v = _perturb(layer.init(jax.random.PRNGKey(seed), x, m, x, m), seed)
    port = _load(pe.StrideConformerEncoderLayer(
        D, H, FF, 15, causal, "swish", "layer_norm", stride=2, grouped=True,
        group_size=3), _in_layer(v), "encoder.encoders.0.")
    return layer, v, port


@pytest.mark.parametrize("causal", [True, False])
def test_strided_conv_and_stride_layer_match_flax(causal):
    """T=23 (odd: the stride gives ceil(23/2) = 12 rows), lengths 23, 16
    and 7: the strided conv module (its output rows past each strided
    length zeroed) and the whole stride layer, grouped, with the AvgPool
    residual, atol 1e-5; then one cached step of the layer (a cnn cache of
    14 rows, an att cache of 10): output and both caches."""
    rs = np.random.RandomState(2)
    flax_layer, v, port = _flax_stride_layer(causal, 3 + causal)
    B, T = 3, 23
    lens = np.asarray([23, 16, 7])
    x = rs.standard_normal((B, T, D)).astype(np.float32)
    pos = rs.standard_normal((1, T, D)).astype(np.float32)
    pad = np.arange(T)[None, None, :] < lens[:, None, None]
    conv = je.StridedConvolutionModule(D, 15, norm="layer_norm",
                                       causal=causal, stride=2)
    cv = {k: t["conv_module"] for k, t in v.items()}
    want_c, _ = conv.apply(cv, jnp.asarray(x), jnp.asarray(pad))
    want, _, _ = flax_layer.apply(v, jnp.asarray(x), jnp.asarray(pad),
                                  jnp.asarray(pos), jnp.asarray(pad))
    with torch.no_grad():
        got_c, _ = port.conv_module(_t(x), torch.from_numpy(pad))
        got = port(_t(x), torch.from_numpy(pad), _t(pos),
                   torch.from_numpy(pad))
    assert got.shape == (B, 12, D) and got_c.shape == (B, 12, D)
    _close(got_c, want_c)
    _close(got, want)
    if not causal:
        return
    C, c = 10, 16
    xc = rs.standard_normal((B, c, D)).astype(np.float32)
    posc = rs.standard_normal((1, C + c, D)).astype(np.float32)
    att = rs.standard_normal((B, H, C, D // H * 2)).astype(np.float32)
    cnn = rs.standard_normal((B, 14, D)).astype(np.float32)
    mask = np.asarray(jax_cache_key_mask(C, c, 6, B))
    want, want_a, want_n = flax_layer.apply(
        v, jnp.asarray(xc), jnp.asarray(mask), jnp.asarray(posc), None,
        (jnp.asarray(att), 6), jnp.asarray(cnn))
    with torch.no_grad():
        got, got_a, got_n = port.forward_cached(
            _t(xc), torch.from_numpy(mask), _t(posc), _t(att), _t(cnn))
    assert got.shape == (B, c // 2, D)
    _close(got, want)
    _close(got_a, want_a)
    _close(got_n, want_n)


# --------------------------------------------------------------------------- #
# the encoder
# --------------------------------------------------------------------------- #
def _encoders(causal, seed=0, **conf):
    """A flax encoder with perturbed variables and the port's encoder with
    the same weights."""
    kw = dict(ENC, **NO_DROP, **conf)
    cmvn = (np.full(FEAT, 0.5, np.float32), np.full(FEAT, 0.8, np.float32))
    flax_enc = je.EfficientConformerEncoder(
        input_size=FEAT, causal=causal, use_dynamic_chunk=causal,
        cmvn=FlaxCMVN(*cmvn), **kw)
    v = jax.jit(functools.partial(flax_enc.init, decoding_chunk_size=-1))(
        {"params": jax.random.PRNGKey(seed),
         "chunk": jax.random.PRNGKey(seed)},
        jnp.zeros((1, WIN, FEAT)), jnp.asarray([WIN]))
    v = _perturb(v, seed)
    port = _load(pe.EfficientConformerEncoder(
        FEAT, causal=causal, use_dynamic_chunk=causal,
        cmvn=GlobalCMVN(*cmvn), **kw),
        {k: {"encoder": t} for k, t in v.items()}, "encoder.")
    return flax_enc, v, port


@pytest.fixture(scope="module")
def stream_encoders():
    return _encoders(True)


@pytest.mark.parametrize("causal", [True, False])
def test_encoder_matches_flax(causal, stream_encoders):
    """Full context, T=127 with lengths 127, 100, 55: T' = 31, 25, 14
    before the stride and 16, 13, 7 after it (the ceil); the masks
    equal and the output within 1e-5 over the valid rows; layers 2-3 (the
    tail) run the full-context layer kernel's plain twin, checked by a
    spy."""
    flax_enc, v, port = stream_encoders if causal else _encoders(False, 1)
    assert port.tail_start == 2 and port.kernels == [15, 7]
    assert [type(l).__name__ for l in port.encoders] == [
        "_EffConformerLayer", "StrideConformerEncoderLayer",
        "_EffConformerLayer", "_EffConformerLayer"]
    rs = np.random.RandomState(3)
    speech = rs.standard_normal((3, 127, FEAT)).astype(np.float32)
    lens = np.asarray([127, 100, 55])
    want, want_m = flax_enc.apply(v, jnp.asarray(speech), jnp.asarray(lens),
                                  decoding_chunk_size=-1,
                                  num_decoding_left_chunks=-1)
    calls = []
    layer_cls = type(port.encoders[2])
    orig = layer_cls.forward_full_context

    def spy(self, *a):
        calls.append(self)
        return orig(self, *a)

    layer_cls.forward_full_context = spy
    try:
        with torch.no_grad():
            got, got_m = port(_t(speech), torch.from_numpy(lens))
    finally:
        layer_cls.forward_full_context = orig
    assert calls == [port.encoders[2], port.encoders[3]]
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
    assert got_m[:, 0].sum(1).tolist() == [16, 13, 7]
    for b, n in enumerate([16, 13, 7]):
        _close(got[b, :n], np.asarray(want)[b, :n])


def test_static_chunk_encode_matches_flax():
    """A static-chunk encoder (static_chunk_size 4, no dynamic chunk) keeps
    its block mask, strided after the stride layer: every layer eager, the
    tail's attention through the flash route (its plain twin here; 2
    calls, one a tail layer), the output within 1e-5."""
    flax_enc, v, port = _encoders(False, 2, static_chunk_size=4)
    rs = np.random.RandomState(4)
    speech = rs.standard_normal((2, 131, FEAT)).astype(np.float32)
    lens = np.asarray([131, 90])
    want, _ = flax_enc.apply(v, jnp.asarray(speech), jnp.asarray(lens),
                             decoding_chunk_size=-1,
                             num_decoding_left_chunks=-1)
    calls = []
    orig = pa.rel_pos_flash_attention

    def spy(*a, **k):
        calls.append(a[6].shape)
        return orig(*a, **k)

    pa.rel_pos_flash_attention = spy
    try:
        with torch.no_grad():
            got, m = port(_t(speech), torch.from_numpy(lens))
    finally:
        pa.rel_pos_flash_attention = orig
    assert calls == [(2, 16, 16)] * 2
    for b, n in enumerate(m[:, 0].sum(1).tolist()):
        _close(got[b, :n], np.asarray(want)[b, :n])


# --------------------------------------------------------------------------- #
# streaming
# --------------------------------------------------------------------------- #
def _jax_chain(flax_enc, v, windows, C, method=je.EfficientConformerEncoder):
    """masr_tpu's forward_chunk over windows (T, B, WIN, FEAT), the state
    advanced as its get_encoder_out_chunk does → (outputs per chunk, final
    state)."""
    st = flax_enc.apply(v, method=lambda m: m.init_cache(
        batch=windows.shape[1], cache_size=C))
    step = jax.jit(lambda w, s: flax_enc.apply(
        v, w, s["offset"], s["att_cache"], s["cnn_cache"], s["cache_len"],
        method=method.forward_chunk))
    factor = flax_enc.apply(v, method=lambda m: m.total_factor()) \
        if hasattr(method, "total_factor") else 1
    outs = []
    for w in windows:
        ys, att, cnn = step(jnp.asarray(w), st)
        full = ys.shape[1] * factor
        st = {"att_cache": att, "cnn_cache": cnn,
              "offset": st["offset"] + full,
              "cache_len": jnp.minimum(st["cache_len"] + full, C)}
        outs.append(np.asarray(ys))
    return outs, st


def _check_state(state, st_j, n):
    _close(state["att_cache"], st_j["att_cache"])
    _close(state["cnn_cache"], st_j["cnn_cache"])
    assert state["offset"].tolist() == [int(st_j["offset"])] * n
    assert state["cache_len"].tolist() == [int(st_j["cache_len"])] * n


def test_forward_chunk_chain_matches_flax(stream_encoders):
    """Seven chained chunks of 16 frames on a 32-row cache (more than C/16
    = 2 windows: the cache fills and rolls; layers 2-3 read its odd rows
    and store theirs twice), B=2: each chunk's 8 output frames and the
    final att and cnn caches within 1e-5, offsets and cache lengths
    exactly."""
    flax_enc, v, port = stream_encoders
    C = 32
    rs = np.random.RandomState(5)
    windows = rs.standard_normal((7, 2, WIN, FEAT)).astype(np.float32)
    want, st_j = _jax_chain(flax_enc, v, windows, C)
    state = port.init_cache(batch=2, cache_size=C)
    assert set(state) == {"att_cache", "cnn_cache", "offset", "cache_len"}
    assert tuple(state["cnn_cache"].shape) == (4, 2, 14, D)
    for w, y_j in zip(windows, want):
        y = port.forward_chunk(_t(w), state)
        assert y.shape == (2, CH // 2, D)
        _close(y, y_j)
    _check_state(state, st_j, 2)
    assert state["offset"].tolist() == [7 * CH] * 2


def test_forward_chunk_batched_staggered_matches_flax(stream_encoders):
    """Three slots that start at ticks 0, 1 and 3 and stop at ticks 6, 4
    and 6 (inactive slots' state untouched), against one masr_tpu chain
    per slot, atol 1e-5; the inactive slots' output rows are zero."""
    flax_enc, v, port = stream_encoders
    C, T = 32, 6
    rs = np.random.RandomState(6)
    windows = rs.standard_normal((3, T, WIN, FEAT)).astype(np.float32)
    starts, stops = [0, 1, 3], [6, 4, 6]
    want = [_jax_chain(flax_enc, v, windows[s, :stops[s] - starts[s], None],
                       C) for s in range(3)]
    state = port.init_cache(batch=3, cache_size=C)
    got = [[] for _ in range(3)]
    for t in range(T):
        active = np.asarray([starts[s] <= t < stops[s] for s in range(3)])
        xs = np.zeros((3, WIN, FEAT), np.float32)
        for s in np.flatnonzero(active):
            xs[s] = windows[s, t - starts[s]]
        before = {k: v_.clone() for k, v_ in state.items()}
        ys = port.forward_chunk_batched(_t(xs), state, None,
                                        torch.from_numpy(active))
        for s in range(3):
            if active[s]:
                got[s].append(ys[s].numpy())
            else:
                assert not ys[s].any()
                for k in state:
                    dim = 1 if state[k].dim() > 1 else 0
                    assert torch.equal(state[k].select(dim, s),
                                       before[k].select(dim, s))
    for s in range(3):
        outs, st_j = want[s]
        _close(np.stack(got[s]), np.concatenate(outs))
        _close(state["att_cache"][:, s], np.asarray(st_j["att_cache"])[:, 0])
        _close(state["cnn_cache"][:, s], np.asarray(st_j["cnn_cache"])[:, 0])
        assert int(state["offset"][s]) == int(st_j["offset"])
        assert int(state["cache_len"][s]) == int(st_j["cache_len"])


def test_conformer_non_causal_chunk_matches_flax():
    """Non-causal chunk stepping of the Conformer (no cnn cache, every conv
    within its chunk), five chunks on a 32-row cache, B=2: the eager step
    (no chunk kernel, nothing packed) against masr_tpu's forward_chunk:
    outputs and the att cache (rings with write pointer 0) within 1e-5,
    then three staggered slots of forward_chunk_batched, each against its
    own chain."""
    from masr_tpu.models.conformer import ConformerEncoder as FlaxConformer
    from masr_tpu_torch.models.conformer import ConformerEncoder
    kw = dict(output_size=D, attention_heads=H, linear_units=FF,
              num_blocks=2, cnn_module_kernel=7, cnn_module_norm="layer_norm",
              use_dynamic_chunk=True, causal=False, **NO_DROP)
    flax_enc = FlaxConformer(input_size=FEAT, **kw)
    v = _perturb(jax.jit(functools.partial(
        flax_enc.init, decoding_chunk_size=-1))(
        {"params": jax.random.PRNGKey(7), "chunk": jax.random.PRNGKey(7)},
        jnp.zeros((1, WIN, FEAT)), jnp.asarray([WIN])), 7)
    port = _load(ConformerEncoder(FEAT, **kw),
                 {k: {"encoder": t} for k, t in v.items()}, "encoder.")
    assert not port.position_tables and not port.multi_chunk
    assert port.pack_chunk_params(cache_size=32) is None
    C = 32
    rs = np.random.RandomState(7)
    windows = rs.standard_normal((5, 2, WIN, FEAT)).astype(np.float32)
    want, st_j = _jax_chain(flax_enc, v, windows, C, FlaxConformer)
    state = port.init_cache(batch=2, cache_size=C)
    for w, y_j in zip(windows, want):
        _close(port.forward_chunk(_t(w), state), y_j)
    _check_state(state, st_j, 2)
    assert state["wptr"].tolist() == [0, 0]
    # staggered slots
    starts, stops = [0, 2, 1], [5, 4, 3]
    state = port.init_cache(batch=3, cache_size=C)
    got = [[] for _ in range(3)]
    for t in range(5):
        active = np.asarray([starts[s] <= t < stops[s] for s in range(3)])
        xs = np.zeros((3, WIN, FEAT), np.float32)
        for s in np.flatnonzero(active):
            xs[s] = windows[t - starts[s], s % 2]
        ys = port.forward_chunk_batched(_t(xs), state, None,
                                        torch.from_numpy(active))
        for s in np.flatnonzero(active):
            got[s].append(ys[s].numpy())
    for s in range(3):
        outs, _ = _jax_chain(flax_enc, v,
                             windows[:stops[s] - starts[s], s % 2][:, None],
                             C, FlaxConformer)
        _close(np.stack(got[s]), np.concatenate(outs))


# --------------------------------------------------------------------------- #
# bundles: the model, the predictor and the engine
# --------------------------------------------------------------------------- #
def _export(out, streaming, seed):
    """A tiny Efficient-Conformer bundle that masr_tpu exports, weights
    from a seed, perturbed, the CTC head x8 (frames peak on varied tokens,
    as a trained model's do) → the bundle dir. dB normalization is off:
    its gain is taken over each call's buffer, so with it on, masr_tpu's
    engine and predict_stream already read this family's random-weight
    frames differently (near ties)."""
    from masr_tpu.infer.bundle import save_inference_bundle
    from masr_tpu.models.registry import build_model
    mean, istd = np.full(FEAT, 15.0), np.full(FEAT, 0.33)
    model = build_model("efficient_conformer", FEAT, len(VOCAB),
                        streaming=streaming, encoder_conf=ENC,
                        decoder_conf=DEC, model_conf=dict(ctc_weight=0.5),
                        cmvn=FlaxCMVN(mean, istd))
    rng = jax.random.PRNGKey(seed)
    v = jax.jit(model.init, static_argnames=("train",))(
        {"params": rng, "dropout": rng, "chunk": rng},
        jnp.zeros((1, WIN, FEAT)), jnp.asarray([WIN]),
        jnp.zeros((1, 4), jnp.int32), jnp.asarray([4]), train=False)
    v = _perturb(v, seed, 0.1)
    v["params"]["ctc"]["ctc_lo"] = {
        k: t * 8.0 for k, t in v["params"]["ctc"]["ctc_lo"].items()}
    save_inference_bundle(out, "efficient_conformer", streaming, FEAT, VOCAB,
                          mean, istd, ENC, DEC, dict(ctc_weight=0.5),
                          {"feature_method": "fbank", "n_mels": FEAT,
                           "use_dB_normalization": False}, v)
    return out


@pytest.fixture(scope="module")
def bundles(tmp_path_factory):
    """{streaming: bundle dir}: streaming (causal conv, dynamic chunk) and
    offline (non-causal)."""
    return {s: _export(str(tmp_path_factory.mktemp(f"eff_{s}")), s,
                       13 if s else 6) for s in (True, False)}


@pytest.mark.parametrize("streaming", [True, False],
                         ids=["streaming", "offline"])
def test_model_probs_match_flax(bundles, streaming):
    """get_encoder_out of the same bundle: lengths equal (T' 16, 13, 7 at
    the final rate), CTC probs within 3e-5 over the valid frames."""
    from masr_tpu.infer.bundle import load_inference_bundle as jax_load
    from masr_tpu_torch.infer.bundle import load_inference_bundle
    jmodel, jv, _, _ = jax_load(bundles[streaming])
    port, _, _ = load_inference_bundle(bundles[streaming])
    rs = np.random.RandomState(8)
    speech = (15.0 + 3.0 * rs.standard_normal((3, 127, FEAT))).astype(
        np.float32)
    lens = np.asarray([127, 100, 55])
    want_p, want_l = jmodel.apply(jv, jnp.asarray(speech), jnp.asarray(lens),
                                  method=type(jmodel).get_encoder_out)
    with torch.no_grad():
        got_p, got_l = port.get_encoder_out(_t(speech),
                                            torch.from_numpy(lens))
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(want_l))
    assert got_l.tolist() == [16, 13, 7]
    for b, n in enumerate(got_l.tolist()):
        _close(got_p[b, :n], np.asarray(want_p)[b, :n], 3e-5)


def _wave(seed, n_chars):
    """Speech-like audio from the synthetic voice over a noise floor."""
    from masr_tpu_torch.audio.synth_tts import SyntheticTTS
    rs = np.random.RandomState(seed)
    text = "".join(rs.choice(list("上家音月火少风大你下雪蓝右黑真"), n_chars))
    wav = SyntheticTTS(sample_rate=16000).render(text, spk_id=seed % 4)
    return wav + 1e-3 * rs.standard_normal(len(wav)).astype(np.float32)


def _predictors(model_dir, fused=True):
    from masr_tpu.infer.predictor import MASRPredictor as JaxPredictor
    from masr_tpu_torch.infer.predictor import MASRPredictor
    return (MASRPredictor(model_dir=model_dir, device="cpu", warmup=False,
                          fused_frontend=fused),
            JaxPredictor(model_dir=model_dir, warmup=False,
                         fused_frontend=fused))


@pytest.fixture(scope="module")
def stream_predictors(bundles):
    return {fused: _predictors(bundles[True], fused)
            for fused in (True, False)}


def test_predict_and_predict_batch_match_masr_tpu(stream_predictors):
    """Same texts (scores within 1e-3), one by one and as a batch."""
    port, ref = stream_predictors[True]
    wavs = [_wave(s, n) for s, n in ((0, 9), (1, 4), (2, 14))]
    got = [port.predict(w) for w in wavs]
    want = [ref.predict(w) for w in wavs]
    assert [g["text"] for g in got] == [w["text"] for w in want]
    for g, w in zip(got, want):
        assert abs(g["score"] - w["score"]) <= 1e-3
    assert [g["text"] for g in port.predict_batch(wavs)] == \
        [w["text"] for w in ref.predict_batch(wavs)]
    assert len({g["text"] for g in got}) == 3 and all(g["text"] for g in got)


def _stream(predictor, wav, piece=None):
    piece = piece or len(wav)
    out = None
    for i in range(0, len(wav), piece):
        r = predictor.predict_stream(wav[i:i + piece],
                                     is_end=i + piece >= len(wav),
                                     sample_rate=16000)
        out = r if r is not None else out
    predictor.reset_stream()
    return out["text"]


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "host"])
def test_predict_stream_matches_masr_tpu(stream_predictors, fused):
    """Whole and in 0.2 s pieces: the port's text equals masr_tpu's for the
    same feeding (8 frames a window)."""
    port, ref = stream_predictors[fused]
    texts = []
    for seed, n_chars in ((0, 11), (1, 4)):
        wav = _wave(seed, n_chars)
        for piece in (None, PIECE):
            got, want = _stream(port, wav, piece), _stream(ref, wav, piece)
            assert got == want, (seed, piece)
            texts.append(got)
    assert texts[0] != texts[2] and all(texts)


def _interleaved(sess, waves, step):
    """Stream k starts k pieces late; all ready slots go through feed_many
    → the final text of every stream."""
    slots = [sess.open() for _ in waves]
    texts = [None] * len(waves)
    for i in range(max(len(w) for w in waves) // step + 1 + len(waves)):
        items = [(slot, waves[k][(i - k) * step:(i - k + 1) * step],
                  (i - k + 1) * step >= len(waves[k]))
                 for k, slot in enumerate(slots)
                 if i >= k and (i - k) * step < len(waves[k])]
        for slot, r in sess.feed_many(items).items():
            if r is not None:
                texts[slots.index(slot)] = r["text"]
    for slot in slots:
        sess.close(slot)
    return texts


def test_engine_matches_masr_tpu(stream_predictors):
    """Three staggered streams through BatchStreamSession: masr_tpu's
    engine's texts and the port's own predict_stream texts; no position
    tables, nothing packed, one dispatch per tick, tick_chunks=2 falls
    back to 1; a reopened slot gives the same text again."""
    from masr_tpu.infer.batch_stream import \
        BatchStreamSession as JaxSession
    from masr_tpu_torch.infer.batch_stream import BatchStreamSession
    port, ref = stream_predictors[False]
    conf = port.predictor.meta["preprocess_conf"]
    waves = [_wave(20 + s, 5 + 4 * s) for s in range(3)]
    sess = BatchStreamSession(port.predictor, port._vocab_list,
                              preprocess_conf=conf, max_streams=4,
                              tick_chunks=2)
    assert sess.tick_k == 1 and sess._packed_chunk is None
    assert sess._pos_cap is None
    got = _interleaved(sess, waves, 4000)
    want = _interleaved(JaxSession(ref.predictor,
                                   ref._text_featurizer.vocab_list,
                                   preprocess_conf=conf, max_streams=4),
                        waves, 4000)
    assert got == want
    assert got == [_stream(port, w) for w in waves]
    assert len(set(got)) == 3
    assert _interleaved(sess, waves[::-1], 4000) == got[::-1]


def test_server_with_max_streams_matches_masr_tpu(bundles):
    """The streaming bundle served by the port's ASRServer (CPU) with
    max_streams 2 and by masr_tpu's: /recognition gives masr_tpu's
    predictor's text, and two WebSocket connections at once through the
    port's engine give every reply masr_tpu's batched server gives each
    alone (texts equal, final scores within 1e-3)."""
    import asyncio
    import json
    import urllib.request
    from masr_tpu.infer.predictor import MASRPredictor as JaxPredictor
    from masr_tpu.infer.server import ASRServer as JaxServer
    from masr_tpu_torch.infer.predictor import MASRPredictor
    from test_torch_server import (_free_port, _pieces, _same_replies,
                                   _session, _start, _wav_bytes)
    path = bundles[True]
    ref_pred = JaxPredictor(path, warmup=False)
    srv = _start(MASRPredictor(path, device="cpu", warmup=False),
                 max_streams=2)
    ref = JaxServer(JaxPredictor(path, warmup=False), host="127.0.0.1",
                    port=_free_port(), ws_port=_free_port(), max_streams=2)
    ref.start(block=False)
    try:
        wavs = [_wave(30 + k, 6 + 3 * k) for k in range(2)]
        raw = _wav_bytes(wavs[0], os.path.join(path, "..", "one.wav"))
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.port}/recognition", data=raw,
            headers={"Content-Type": "application/octet-stream"})
        with urllib.request.urlopen(req, timeout=60) as r:
            got = json.loads(r.read().decode("utf-8"))
        assert got["code"] == 0
        assert got["result"] == ref_pred.predict(wavs[0])["text"]
        conns = [[_pieces(w)] for w in wavs]
        uri = "ws://127.0.0.1:{}/"
        want = [asyncio.run(_session(uri.format(ref.ws_port), c))
                for c in conns]

        async def together():
            return await asyncio.gather(*[
                _session(uri.format(srv.ws_port), c) for c in conns])

        for g, w in zip(asyncio.run(together()), want):
            _same_replies(g, w)
    finally:
        srv.stop()
        ref.stop()
