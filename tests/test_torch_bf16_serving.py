"""bf16 serving of the Conformer in the port (build_model(dtype=
torch.bfloat16), InferencePredictor(dtype=...), the bf16 modes of rows 1,
2 and 5) against masr_tpu at dtype=jnp.bfloat16, on the CPU, at small
widths (D=64, 2 heads, FFN 96 for the rows and 128 for the models, conv
kernel 7, 2 blocks) and on the example bundle (D=48).

The masr_tpu route each test holds the port against:
- rows 1, 2, 5: masr_tpu's Pallas kernels at bf16 in interpret mode
  (fused_conformer_layer, fused_chunk_layer, rel_pos_flash_attention)
  against the plain twins' bf16 mode;
- the offline encode: masr_tpu's TPU serving route at bf16, the flax
  subsampling, every layer through its Pallas layer kernel
  (ConformerEncoderLayer.fused_full_context, interpret mode), after_norm
  and the CTC head;
- the chained stream: masr_tpu's forward_chunk_batched (the Pallas chunk
  kernel per layer, interpret mode) at bf16, its bf16 caches carried into
  the port halfway by models/weights.py's converters;
- the static-chunk encode: masr_tpu's XLA layers at bf16 with
  use_flash_attention=True (its `_flash` runs the Pallas attention in
  interpret mode), as the port runs eager layers with row 5 there;
- the example bundle: masr_tpu's InferencePredictor(dtype=bf16) as it runs
  on the CPU (its XLA layers): the same greedy texts, and its attention
  rescoring scores;
- the engine: the port's own bf16 single-stream chunk steps.

Tolerances. bf16 keeps 8 significant bits: one rounding moves a value by
at most 2^-8 of it. Both sides round the same operands at the same points
and sum in f32 in other orders, so a rounding flips here and there and
moves a value by a rounding or two (a row's kernel and twin, or a bf16
logit). `_bf16_close` allows a max abs error of 8 roundings of the
largest value and a mean abs error of one rounding of the mean magnitude
(an f32 port against masr_tpu's bf16 fails the mean by ~1.5x). The CTC
logits are bf16 rows held so too; the f32 log-softmax moves no
log-probability by more than twice the largest logit error (|d(l_i -
lse)| <= |d l_i| + max |d l|), the bound the probabilities are held to,
with 1e-5 for the f32 softmax's own sums.
"""
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from masr_tpu.models.cmvn import GlobalCMVN as FlaxCMVN
from masr_tpu.models.conformer import ConformerEncoder as FlaxEncoder
from masr_tpu.models.conformer import ConformerEncoderLayer as FlaxLayer
from masr_tpu.models.registry import build_model as build_flax_model
from masr_tpu.ops.masks import make_pad_mask
from masr_tpu.ops.pallas import attention as jat
from masr_tpu.ops.pallas import chunk_layer as jck
from masr_tpu.ops.pallas import conformer_layer as jcl
from masr_tpu_torch.models.cmvn import GlobalCMVN
from masr_tpu_torch.models.registry import build_model
from masr_tpu_torch.models.weights import (from_flax_variables,
                                           right_aligned_from_ring,
                                           ring_from_right_aligned)
from masr_tpu_torch.ops.cuda import chunk_layer as ck
from masr_tpu_torch.ops.cuda import conformer_layer as cl
from masr_tpu_torch.ops.cuda import rel_pos_attention as rpa
from test_torch_threads import one_torch_thread  # noqa: F401

BF = torch.bfloat16
D, H, FF, K = 64, 2, 96, 7
d_k = D // H
FEAT, VOCAB = 80, 50
ENC = dict(output_size=D, attention_heads=H, linear_units=128,
           num_blocks=2, cnn_module_kernel=K, dropout_rate=0.0,
           positional_dropout_rate=0.0, attention_dropout_rate=0.0)
DEC = dict(attention_heads=2, linear_units=64, num_blocks=1, r_num_blocks=1)
REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
EXAMPLE = os.path.join(REPO, "examples", "tiny_zh_synth", "inference_model")
HELD_OUT = [("上家音月火少", 0), ("风大你火下雪", 1), ("蓝右黑真", 0)]


def _f32(a):
    """torch (any dtype) or jax/numpy → numpy f32 (bf16 values exactly)."""
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _tb(a):
    """jax/numpy → torch bf16 (a bf16 array exactly)."""
    return torch.from_numpy(_f32(a)).to(BF)


def _bf16_close(got, want, n_max=8, n_mean=1):
    """max |got - want| <= n_max roundings (2^-8) of max(1, max |want|);
    mean |got - want| <= n_mean roundings of the mean |want|."""
    got, want = _f32(got), _f32(want)
    err = np.abs(got - want)
    top = max(1.0, float(np.abs(want).max()))
    assert err.max() <= n_max * 2 ** -8 * top, (err.max(), top)
    assert err.mean() <= n_mean * 2 ** -8 * float(np.abs(want).mean()), (
        err.mean(), float(np.abs(want).mean()))


def _probs_close(got, want, logits_got, logits_want):
    """bf16 logits _bf16_close, and the f32 probabilities' logs within twice
    the largest logit error (+1e-5)."""
    _bf16_close(logits_got, logits_want)
    bound = 2 * np.abs(_f32(logits_got) - _f32(logits_want)).max() + 1e-5
    err = np.abs(np.log(_f32(got)) - np.log(_f32(want)))
    assert err.max() <= bound, (err.max(), bound)


# --------------------------------------------------------------------------- #
# rows 1, 2, 5: the twins' bf16 modes against the Pallas kernels at bf16
# --------------------------------------------------------------------------- #
def _flax_layer(seed, causal):
    layer = FlaxLayer(size=D, attention_heads=H, linear_units=FF,
                      cnn_module_kernel=K, causal=causal, dropout_rate=0.0,
                      attention_dropout_rate=0.0)
    x = jnp.zeros((1, 8, D))
    mask = jnp.ones((1, 1, 8), bool)
    v = layer.init(jax.random.PRNGKey(seed), x, mask, jnp.zeros((1, 8, D)),
                   mask)
    rs = np.random.RandomState(seed)
    return jax.tree.map(lambda l: np.asarray(l) + rs.standard_normal(
        l.shape).astype(np.float32) * 0.05, v["params"])


def _packs(params):
    """masr_tpu's bf16 pack → (torch pack: bf16 products, f32 rows; jax
    pack; linear_pos (in, out) f32 numpy)."""
    pj = jcl.pack_layer_params(params, jnp.bfloat16)
    wpos = _f32(pj.pop("linear_pos"))
    pt = {k: _tb(v) if v.dtype == jnp.bfloat16
          else torch.from_numpy(_f32(v).copy()) for k, v in pj.items()}
    return pt, pj, wpos


def _bf(rs, shape, scale=1.0):
    return jnp.asarray(rs.standard_normal(shape).astype(np.float32)
                       * scale).astype(jnp.bfloat16)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_row1_bf16_twin_matches_pallas(causal):
    """fused_conformer_layer's bf16 mode (the twin on CPU tensors) ==
    masr_tpu's fused_conformer_layer at bf16, B=2 ragged (T=40, 27 valid),
    valid rows, _bf16_close; the output is bf16."""
    pt, pj, _ = _packs(_flax_layer(3, causal))
    rs = np.random.RandomState(0)
    x, posp = _bf(rs, (2, 40, D)), _bf(rs, (40, D), 0.3)
    lens = np.asarray([40, 27], np.int32)
    want = jcl.fused_conformer_layer(x, jnp.asarray(lens), posp, pj,
                                     n_head=H, ksize=K, causal=causal,
                                     interpret=True)
    got = cl.fused_conformer_layer(_tb(x), torch.from_numpy(lens),
                                   _tb(posp), pt, n_head=H, ksize=K,
                                   causal=causal)
    assert got.dtype == BF
    for b, n in enumerate(lens):
        _bf16_close(got[b, :n], want[b, :n])


def _chunk_inputs(rs, B, C, c):
    return (_bf(rs, (B, c, D), 0.3), _bf(rs, (B, H, C, 2 * d_k), 0.5),
            _bf(rs, (B, K - 1, D), 0.5))


def test_row2_bf16_twin_matches_pallas_with_inactive_slot():
    """fused_chunk_layer's bf16 mode == masr_tpu's fused_chunk_layer at bf16
    (per-slot positions), B=4, cache_len {0, 5, 16, full}, ring write
    pointers != 0 on the port's side: the active slots' outputs, rings and
    cnn caches _bf16_close (the caches bf16); the inactive slot's caches
    stay bitwise unchanged."""
    B, C, c = 4, 64, 16
    rs = np.random.RandomState(1)
    pt, pj, _ = _packs(_flax_layer(4, True))
    x, att, cnn = _chunk_inputs(rs, B, C, c)
    posp = _bf(rs, (B, C + c, D), 0.3)
    clens = np.asarray([0, 5, 16, C], np.int32)
    y_j, att_j, cnn_j = jck.fused_chunk_layer(
        x, posp, att, cnn, jnp.asarray(clens), pj, n_head=H, ksize=K,
        interpret=True)
    wptr = np.asarray([0, 9, 63, 32], np.int32)
    ring, cnn_t = ring_from_right_aligned(att, wptr), _tb(cnn)
    assert ring.dtype == BF
    ring0, cnn0 = ring.clone(), cnn_t.clone()
    active = torch.tensor([1, 1, 0, 1], dtype=torch.int32)
    y = ck.fused_chunk_layer(
        _tb(x), _tb(posp).reshape(-1, D),
        torch.tensor(np.arange(B) * (C + c), dtype=torch.int32), ring, cnn_t,
        torch.from_numpy(clens), torch.from_numpy(wptr), active, pt,
        n_head=H, ksize=K)
    assert y.dtype == ring.dtype == cnn_t.dtype == BF
    on = [0, 1, 3]
    _bf16_close(y[on], np.asarray(_f32(y_j))[on])
    new = right_aligned_from_ring(ring, (wptr + c) % C)
    _bf16_close(new[on], _f32(att_j)[on])
    _bf16_close(cnn_t[on], _f32(cnn_j)[on])
    assert torch.equal(ring[2], ring0[2]) and torch.equal(cnn_t[2], cnn0[2])


def test_row2_bf16_table_route_matches_pallas():
    """Positions from the bf16 per-layer table (the port's make_chunk_pos_
    table at bf16 against masr_tpu's) at per-slot offsets, c=8, C=32."""
    B, C, c, table_len = 4, 32, 8, 256
    rs = np.random.RandomState(4)
    pt, pj, wpos = _packs(_flax_layer(5, True))
    x, att, cnn = _chunk_inputs(rs, B, C, c)
    clens = np.asarray([0, 8, 24, C], np.int32)
    offsets = np.asarray([0, 8, 40, 200], np.int32)
    tab_j = jck.make_chunk_pos_table(jnp.asarray(wpos).astype(jnp.bfloat16),
                                     C, table_len, jnp.bfloat16)
    y_j, att_j, cnn_j = jck.fused_chunk_layer(
        x, None, att, cnn, jnp.asarray(clens), pj, None, tab_j,
        jck.clamp_pos_starts(jnp.asarray(offsets), table_len, C + c),
        n_head=H, ksize=K, interpret=True)
    tab = ck.make_chunk_pos_table(torch.from_numpy(wpos.T.copy()), C,
                                  table_len, BF)
    assert tab.dtype == BF
    _bf16_close(tab, _f32(tab_j)[:, :D])
    ring, cnn_t = _tb(att), _tb(cnn)
    y = ck.fused_chunk_layer(
        _tb(x), tab, ck.clamp_pos_starts(torch.from_numpy(offsets),
                                         table_len, C + c),
        ring, cnn_t, torch.from_numpy(clens), torch.zeros(B, dtype=torch.int32),
        torch.ones(B, dtype=torch.int32), pt, n_head=H, ksize=K)
    _bf16_close(y, y_j)
    _bf16_close(right_aligned_from_ring(ring, [c] * B), att_j)
    _bf16_close(cnn_t, cnn_j)


def test_row5_bf16_twin_matches_pallas():
    """rel_pos_flash_attention's bf16 mode == masr_tpu's at bf16 (a causal
    mask, utterance 1 padded past 50 keys), _bf16_close, bf16 output."""
    B, T = 2, 70
    rs = np.random.RandomState(2)
    q, k, v = (_bf(rs, (B, H, T, d_k)) for _ in range(3))
    p = _bf(rs, (H, T, d_k))
    bu, bv = _bf(rs, (H, d_k), 0.1), _bf(rs, (H, d_k), 0.1)
    mask = np.tril(np.ones((T, T), bool))[None].repeat(B, 0)
    mask[1, :, 50:] = False
    want = jat.rel_pos_flash_attention(q, k, v, p, bu, bv, jnp.asarray(mask),
                                       interpret=True)
    got = rpa.rel_pos_flash_attention(*(_tb(a) for a in (q, k, v, p, bu,
                                                          bv)),
                                      torch.from_numpy(mask))
    assert got.dtype == BF
    _bf16_close(got, want)


def test_serving_wrappers_refuse_mixed_and_other_dtypes():
    """Rows 1, 2 and 5 take f32 or bf16, one of them throughout: a bf16 x
    with an f32 pack, an f32 cache under a bf16 x, or f16 operands raise
    (no silent upcast)."""
    from masr_tpu_torch.models.conformer import ConformerEncoderLayer
    layer = ConformerEncoderLayer(D, H, FF, cnn_module_kernel=K, causal=True)
    x = torch.randn(2, 8, D, dtype=BF)
    lens = torch.tensor([8, 5], dtype=torch.int32)
    with pytest.raises(ValueError, match="mixed"):
        cl.fused_conformer_layer(x, lens, torch.randn(8, D, dtype=BF),
                                 cl.pack_layer_params(layer), n_head=H,
                                 ksize=K, causal=True)
    i32 = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="mixed"):
        ck.fused_chunk_layer(x, torch.randn(40, D, dtype=BF), i32,
                             torch.zeros(2, H, 32, 2 * d_k), torch.zeros(
                                 2, K - 1, D, dtype=BF), i32, i32, i32 + 1,
                             cl.pack_layer_params(layer, BF), n_head=H,
                             ksize=K)
    q = torch.randn(1, H, 8, d_k, dtype=torch.float16)
    with pytest.raises(ValueError, match="f32 or bf16"):
        rpa.rel_pos_flash_attention(q, q, q, q[0], q[0, :, 0], q[0, :, 0],
                                    torch.ones(1, 8, 8, dtype=torch.bool))


def test_subsampling_product_matches_flax_dense_and_follows_weights():
    """The subsampling's output Linear (models/layers.py Linear) in bf16: its
    product through serving_product (the plain twin on the CPU) against
    flax's nn.Dense at bf16 on the same bf16 input, K = 19 D as the
    subsampling's. Both round the f32 sums once and add the bias in bf16, a
    second rounding; f32 sums in other orders flip a product's rounding
    here and there (one ulp, at most 2 roundings of a value) and the bias
    add may round once more: max abs error 4 roundings of the largest
    value, mean one. In f32 it is nn.Linear's bits. Its kept bf16 weight
    copy follows an in-place update (the version bumps). serving_product
    takes bf16 only."""
    import flax.linen as fnn
    from masr_tpu_torch.models.layers import Linear
    Kin = 19 * D
    torch.manual_seed(3)
    lin = Linear(Kin, D)
    x = jnp.maximum(_bf(np.random.RandomState(5), (2, 9, Kin)), 0)

    def dense():
        params = {"kernel": lin.weight.detach().numpy().T,
                  "bias": lin.bias.detach().numpy()}
        return fnn.Dense(D, dtype=jnp.bfloat16).apply({"params": params}, x)

    with torch.no_grad():
        got = lin(_tb(x))
        assert got.dtype == BF
        _bf16_close(got, dense(), n_max=4)
        x32 = torch.randn(3, Kin)
        assert torch.equal(lin(x32), torch.nn.functional.linear(
            x32, lin.weight, lin.bias))
        lin.weight.mul_(-2.0)
        again = lin(_tb(x))
    _bf16_close(again, dense(), n_max=4)
    assert not torch.equal(again, got)
    with pytest.raises(ValueError, match="bf16"):
        ck.serving_product(torch.randn(2, Kin),
                           lin.weight.t().contiguous().to(BF))


def test_build_model_bf16_conformer_only():
    """The Conformer builds in bf16 (parameters f32, caches and packs bf16);
    the other families build in bf16 too since their bf16 serving was
    ported (their streaming state bf16, tests/test_torch_bf16_families.py
    holds them against masr_tpu); f16 raises."""
    enc = dict(output_size=32, attention_heads=2, linear_units=32,
               num_blocks=1, cnn_module_kernel=7)
    model = build_model("conformer", FEAT, 10, encoder_conf=enc, dtype=BF)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    state = model.encoder.init_cache(batch=2, cache_size=16)
    assert state["att_cache"].dtype == state["cnn_cache"].dtype == BF
    packed, table = model.encoder.pack_chunk_params(cache_size=16,
                                                    pos_table_len=64)[0]
    assert packed["tc_qkv"].dtype == packed["ffw1"].dtype == table.dtype == BF
    assert packed["lnw"].dtype == torch.float32
    for family, conf in (("squeezeformer", dict(encoder_dim=32,
                                                output_size=32,
                                                num_blocks=2)),
                         ("efficient_conformer", enc),
                         ("deepspeech2", {})):
        other = build_model(family, FEAT, 10, encoder_conf=conf, dtype=BF)
        assert all(p.dtype == torch.float32 for p in other.parameters())
        assert other.encoder.compute_dtype == BF
    with pytest.raises(ValueError, match="f32 or bf16"):
        build_model("conformer", FEAT, 10, encoder_conf=enc,
                    dtype=torch.float16)


# --------------------------------------------------------------------------- #
# the model: offline, streaming, static chunk
# --------------------------------------------------------------------------- #
def _cmvn_and_speech(lens, seed):
    rs = np.random.RandomState(seed)
    mean = rs.uniform(8, 14, FEAT).astype(np.float32)
    istd = rs.uniform(0.2, 0.5, FEAT).astype(np.float32)
    speech = (mean + rs.standard_normal((len(lens), max(lens), FEAT))
              * 3.0).astype(np.float32)
    return mean, istd, speech, np.asarray(lens, np.int32)


def _models(streaming, seed, enc=None):
    """(masr_tpu model at bf16, its perturbed variables, the port's bf16
    model with them, speech, lens)."""
    mean, istd, speech, lens = _cmvn_and_speech([120, 87], seed)
    conf = dict(ENC, **(enc or {}))
    build = lambda **kw: build_flax_model(  # noqa: E731
        "conformer", FEAT, VOCAB, streaming=streaming, encoder_conf=conf,
        decoder_conf=DEC, cmvn=FlaxCMVN(mean, istd), **kw)
    f32 = build()
    v = jax.jit(lambda s, n: f32.init(
        {"params": jax.random.PRNGKey(seed)}, s, n,
        method=type(f32).get_encoder_out))(jnp.asarray(speech),
                                           jnp.asarray(lens))
    rs = np.random.RandomState(seed)
    v = jax.tree.map(lambda l: np.asarray(l) + 0.02 * rs.standard_normal(
        l.shape).astype(np.float32), jax.device_get(v))
    port = build_model("conformer", FEAT, VOCAB, streaming=streaming,
                       encoder_conf=conf, decoder_conf=DEC,
                       cmvn=GlobalCMVN(mean, istd), dtype=BF)
    missing, unexpected = port.load_state_dict(from_flax_variables(v),
                                               strict=False)
    assert not unexpected and all(k.startswith("decoder.") for k in missing)
    return build(dtype=jnp.bfloat16), v, port.eval(), speech, lens


def _fused_serving(mdl, speech, lens):
    """masr_tpu's TPU serving route at its dtype, here with the Pallas layer
    kernel in interpret mode: → (encoder rows, CTC logits, probs, lens)."""
    enc = mdl.encoder
    masks = ~make_pad_mask(lens, speech.shape[1])[:, None, :]
    xs = enc.cmvn(speech).astype(enc.dtype)
    xs, pos_emb, masks = enc.embed(xs, masks, 0, False)
    lens2 = masks[:, 0, :].sum(axis=1).astype(jnp.int32)
    for layer in enc.encoders:
        xs = layer.fused_full_context(xs, lens2, pos_emb)
    xs = enc.after_norm(xs)
    return xs, mdl.ctc.ctc_lo(xs), mdl.ctc.softmax(xs), lens2


@pytest.mark.parametrize("streaming", [True, False],
                         ids=["causal", "full_context"])
def test_offline_encode_matches_masr_tpu_bf16(streaming):
    """get_encoder_out / encode_for_rescoring of the bf16 port (row 1's
    bf16 twin per layer) against masr_tpu's serving route at bf16: encoder
    rows and CTC logits bf16 and _bf16_close, probs f32 and _probs_close,
    valid rows."""
    fm, v, port, speech, lens = _models(streaming, 1 + streaming)
    h_j, lg_j, p_j, l_j = fm.apply(v, jnp.asarray(speech), jnp.asarray(lens),
                                   method=_fused_serving)
    with torch.no_grad():
        enc, probs, out_lens = port.encode_for_rescoring(
            torch.from_numpy(speech), torch.from_numpy(lens))
        logits = port.ctc.logits(enc)
    assert enc.dtype == logits.dtype == BF and probs.dtype == torch.float32
    np.testing.assert_array_equal(out_lens.numpy(), np.asarray(l_j))
    for b, n in enumerate(np.asarray(l_j)):
        _bf16_close(enc[b, :n], h_j[b, :n])
        _probs_close(probs[b, :n], p_j[b, :n], logits[b, :n], lg_j[b, :n])


def test_chunk_stream_matches_masr_tpu_bf16_with_carried_caches():
    """Six chained chunk steps of the bf16 port (row 2's bf16 twin per
    layer, exact positions) against masr_tpu's fused chunk steps at bf16
    over two slots with a 32-row cache (it fills and wraps): after three
    steps masr_tpu's bf16 caches are carried into the port through
    ring_from_right_aligned (they stay bf16); every step's output and the
    final caches _bf16_close."""
    _, v, port, _, _ = _models(True, 5)
    mean, istd = (_f32(port.encoder.global_cmvn.mean),
                  _f32(port.encoder.global_cmvn.istd))
    fenc = FlaxEncoder(input_size=FEAT, causal=True, use_dynamic_chunk=True,
                       cmvn=FlaxCMVN(mean, istd), dtype=jnp.bfloat16, **ENC)
    enc_v = {"params": v["params"]["encoder"]}
    C, CH, WIN = 32, 16, 67
    rs = np.random.RandomState(6)
    windows = (mean + 3.0 * rs.standard_normal((6, 2, WIN, FEAT))).astype(
        np.float32)
    step = jax.jit(lambda vv, x, o, a, cn, cl: fenc.apply(
        vv, x, o, a, cn, cl, method=FlaxEncoder.forward_chunk_batched))
    st = fenc.apply(enc_v, method=lambda m: m.init_cache(batch=2,
                                                         cache_size=C))
    offsets = jnp.zeros((2,), jnp.int32)
    clens = jnp.zeros((2,), jnp.int32)
    att, cnn = st["att_cache"], st["cnn_cache"]
    state = port.encoder.init_cache(batch=2, cache_size=C)
    assert state["att_cache"].dtype == BF
    for i, w in enumerate(windows):
        if i == 3:     # carry masr_tpu's caches into the port
            state["att_cache"] = ring_from_right_aligned(
                att, state["wptr"].numpy())
            state["cnn_cache"] = _tb(cnn)
            assert state["att_cache"].dtype == BF
        y_j, att, cnn = step(enc_v, jnp.asarray(w), offsets, att, cnn,
                             clens)
        offsets, clens = offsets + CH, jnp.minimum(clens + CH, C)
        with torch.no_grad():
            y = port.encoder.forward_chunk(torch.from_numpy(w), state)
        assert y.dtype == BF and att.dtype == jnp.bfloat16
        _bf16_close(y, y_j)
    _bf16_close(right_aligned_from_ring(state["att_cache"], state["wptr"]),
                att)
    _bf16_close(state["cnn_cache"], cnn)
    assert state["offset"].tolist() == [6 * CH] * 2


def test_static_chunk_encode_matches_masr_tpu_bf16(monkeypatch):
    """A static-chunk model (chunk 8, no dynamic chunk) in bf16: the port's
    eager layers with row 5's bf16 mode (2 launches of the flash route per
    encode, 0 of the layer kernel) against masr_tpu's bf16 XLA layers with
    its Pallas attention: encoder rows _bf16_close, probs _probs_close."""
    from masr_tpu_torch.models import attention as attention_module
    from masr_tpu_torch.models import conformer as conformer_module
    calls = {"flash": 0, "layer": 0}

    def count(name, fn):
        def counted(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return counted
    monkeypatch.setattr(attention_module, "rel_pos_flash_attention",
                        count("flash", rpa.rel_pos_flash_attention))
    monkeypatch.setattr(conformer_module, "fused_conformer_layer",
                        count("layer", cl.fused_conformer_layer))
    static = dict(static_chunk_size=8, use_dynamic_chunk=False,
                  use_flash_attention=True)
    fm, v, port, speech, lens = _models(True, 7, static)

    def xla_route(mdl, speech, lens):
        out, mask = mdl.encoder(speech, lens, -1, -1)
        return out, mdl.ctc.ctc_lo(out), mdl.ctc.softmax(out), mask
    h_j, lg_j, p_j, m_j = fm.apply(v, jnp.asarray(speech), jnp.asarray(lens),
                                   method=xla_route)
    with torch.no_grad():
        enc, probs, out_lens = port.encode_for_rescoring(
            torch.from_numpy(speech), torch.from_numpy(lens))
        logits = port.ctc.logits(enc)
    assert calls == {"flash": 2, "layer": 0}
    for b, n in enumerate(np.asarray(m_j)[:, 0].sum(1)):
        _bf16_close(enc[b, :n], h_j[b, :n])
        _probs_close(probs[b, :n], p_j[b, :n], logits[b, :n], lg_j[b, :n])


# --------------------------------------------------------------------------- #
# the example bundle and the engine
# --------------------------------------------------------------------------- #
def _render(text, spk):
    from masr_tpu_torch.audio.synth_tts import SyntheticTTS
    return SyntheticTTS(sample_rate=16000).render(text, spk_id=spk)


@pytest.fixture(scope="module")
def example():
    """The example bundle read at bf16 by both packages' InferencePredictor,
    and the held-out sentences' fbank features."""
    from masr_tpu.infer.inference_model import InferencePredictor as JaxIP
    from masr_tpu_torch.data.audio_featurizer import AudioFeaturizer
    from masr_tpu_torch.infer.inference_model import InferencePredictor
    port = InferencePredictor(EXAMPLE, device="cpu", dtype=BF)
    ref = JaxIP(model_dir=EXAMPLE, dtype=jnp.bfloat16)
    featurizer = AudioFeaturizer(train=False,
                                 **port.meta["preprocess_conf"])
    feats = [featurizer.featurize_waveform(_render(t, s), 16000)
             for t, s in HELD_OUT]
    T = max(len(f) for f in feats)
    speech = np.zeros((len(feats), T, feats[0].shape[1]), np.float32)
    for i, f in enumerate(feats):
        speech[i, :len(f)] = f
    return port, ref, speech, np.asarray([len(f) for f in feats], np.int32)


def _greedy_texts(ids, lens, vocab):
    from masr_tpu_torch.decoders.greedy import _collapse
    return [_collapse(ids[b, :n], np.ones(n), vocab)[1]
            for b, n in enumerate(lens)]


def test_example_bundle_bf16_texts_match_masr_tpu(example):
    """The held-out sentences through predict_greedy at bf16: the port's
    texts == masr_tpu's, and the bundle still reads >= 2 of 3."""
    port, ref, speech, lens = example
    ids, _, out_lens = port.predict_greedy(speech, lens)
    ids_j, _, out_lens_j = ref.predict_greedy(speech, lens)
    np.testing.assert_array_equal(out_lens, np.asarray(out_lens_j))
    got = _greedy_texts(ids, out_lens, port.vocab_list)
    want = _greedy_texts(np.asarray(ids_j), out_lens, port.vocab_list)
    assert got == want
    assert sum(g == t for g, (t, _) in zip(got, HELD_OUT)) >= 2


def test_example_bundle_bf16_rescoring_matches_masr_tpu(example):
    """Attention rescoring at bf16: masr_tpu's encoder rows of the first
    sentence through the port's bf16 decoder (rescore) and masr_tpu's: the
    scores of three hypotheses within 2 roundings of their magnitude."""
    port, ref, speech, lens = example
    enc_j, _, out_j = ref.encode_for_rescoring(speech[:1], lens[:1])
    vocab = port.vocab_list
    hyps = [[vocab.index(ch) for ch in HELD_OUT[0][0] if ch in vocab],
            [vocab.index(ch) for ch in HELD_OUT[1][0] if ch in vocab], [5]]
    want = np.asarray(ref.rescore(enc_j, int(out_j[0]), hyps))
    got = port.rescore(_f32(enc_j), int(out_j[0]), hyps)
    np.testing.assert_allclose(got[:3], want[:3], rtol=2 * 2 ** -8, atol=0)


def test_engine_bf16_texts_equal_single_stream(example):
    """BatchStreamSession over the bf16 predictor (bf16 slot state, one
    dispatch per tick through row 2's bf16 mode) gives each stream the text
    of the port's predict_stream over the same bf16 predictor."""
    from masr_tpu_torch.infer.batch_stream import BatchStreamSession
    from masr_tpu_torch.infer.predictor import MASRPredictor
    port_ip = example[0]
    single = MASRPredictor(model_dir=EXAMPLE, device="cpu", warmup=False,
                           fused_frontend=False)
    single.predictor = port_ip
    rs = np.random.RandomState(0)
    # a noise floor: no piece is digital silence, which dB normalization
    # refuses
    waves = [w + 1e-3 * rs.standard_normal(len(w)).astype(np.float32)
             for w in (_render(t, s) for t, s in HELD_OUT[:2])]
    want = []
    for w in waves:
        out = single.predict_stream(w, is_end=True, sample_rate=16000)
        single.reset_stream()
        want.append(out["text"])
    sess = BatchStreamSession(port_ip, port_ip.vocab_list,
                              preprocess_conf=port_ip.meta[
                                  "preprocess_conf"], max_streams=4)
    assert sess.states["att_cache"].dtype == BF
    slots = [sess.open() for _ in waves]
    got = {}
    for i in range(0, max(len(w) for w in waves), 4000):
        items = [(slot, w[i:i + 4000], i + 4000 >= len(w))
                 for slot, w in zip(slots, waves) if i < len(w)]
        for slot, out in sess.feed_many(items).items():
            if out is not None:
                got[slot] = out["text"]
    assert [got[s] for s in slots] == want
    assert all(want)
