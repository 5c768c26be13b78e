"""The port's Efficient-Conformer training, weights and export against
masr_tpu on the CPU, at the widths of tests/test_torch_efficient_conformer.py
(D=64, 2 heads, 4 blocks, stride at layer 1, groups [0, 1], g=3, conv
kernel 15 → 7), inputs from a numpy seed, dropout 0:

- the encoder's loss path (forward_train: the grouped and stride head
  eagerly, the tail through the training-layer kernel's plain twin),
  causal and not, under a static chunk mask: the output and the grad of
  every parameter and of the input against masr_tpu's encoder with
  train=True;
- the whole model's hybrid loss (CTC through the CTC kernel's plain twin)
  and every parameter's grad, with the layer_norm conv (tail route) and
  the BatchNorm default (every layer eager, the running statistics
  moved as flax moves them);
- the weight map both ways with batch_stats, masr_tpu's converter on the
  port's names, an upstream state_dict with concat_linear, and the port's
  bundle bytes == masr_tpu's in f32, bf16 and int8;
- configs/efficient_conformer.yml built at full width;
- a tiny MASRTrainer run (accum_grad 4 as the config), its eval with every
  decoder, and its export.
Each tolerance is stated where it is used."""
import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from flax.traverse_util import flatten_dict

from masr_tpu.models import efficient_conformer as je
from masr_tpu.models.registry import build_model as build_flax_model
from masr_tpu_torch.models import efficient_conformer as pe
from masr_tpu_torch.models.registry import build_model
from masr_tpu_torch.models.weights import (from_flax_variables,
                                           grads_to_flax_variables,
                                           load_upstream_state_dict,
                                           seeded_state_dict,
                                           to_flax_variables)
from test_torch_threads import one_torch_thread  # noqa: F401

D, H, FF, FEAT = 64, 2, 96, 80
EFF = dict(stride_layer_idx=[1], stride=[2], group_layer_idx=[0, 1],
           group_size=3)
ENC = dict(output_size=D, attention_heads=H, linear_units=FF, num_blocks=4,
           cnn_module_kernel=15, dropout_rate=0.0, attention_dropout_rate=0.0,
           positional_dropout_rate=0.0, efficient_conf=EFF)
DEC = dict(attention_heads=2, linear_units=40, num_blocks=1, r_num_blocks=1,
           dropout_rate=0.0, positional_dropout_rate=0.0)
MODEL_CONF = dict(ctc_weight=0.3, lsm_weight=0.1, reverse_weight=0.3)
VOCAB = 12


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _perturb(tree, rs, scale=0.02):
    return jax.tree.map(lambda l: np.asarray(l) + scale * rs.standard_normal(
        l.shape).astype(np.float32), jax.device_get(tree))


def _assert_grads(named_params, flax_grads, rtol, atol):
    got = grads_to_flax_variables(named_params)["params"]
    flat = jax.tree_util.tree_flatten_with_path(flax_grads)[0]
    assert len(flat) == len(jax.tree_util.tree_leaves(got))
    for path, g in flat:
        node = got
        for k in path:
            node = node[k.key]
        np.testing.assert_allclose(node, np.asarray(g), rtol=rtol, atol=atol,
                                   err_msg=str(path))


# --------------------------------------------------------------------------- #
# the loss path
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("causal", [True, False])
def test_encoder_forward_train_matches_flax(causal):
    """forward_train (train mode, dropout 0, static chunk 4 so the chunk
    mask needs no draw; lengths 127 and 80: T' 16 and 10 after the stride)
    against masr_tpu's encoder with train=True: the output over the valid
    frames atol 1e-5; the grads of sum(sin(out)) over them wrt the input
    atol 1e-5 and wrt every parameter rtol 1e-4 atol 2e-5 (f32, other sum
    orders); the tail runs forward_train (a spy counts 2 calls)."""
    kw = dict(ENC, cnn_module_norm="layer_norm", static_chunk_size=4,
              causal=causal)
    rs = np.random.RandomState(1)
    xs = rs.standard_normal((2, 127, FEAT)).astype(np.float32)
    lens = np.asarray([127, 80], np.int32)
    fenc = je.EfficientConformerEncoder(input_size=FEAT, **kw)
    key = jax.random.PRNGKey(0)
    v = fenc.init({"params": key}, jnp.asarray(xs), jnp.asarray(lens))
    params = _perturb(v["params"], rs)

    def loss(p, x):
        y, masks = fenc.apply({"params": p}, x, jnp.asarray(lens),
                              train=True, rngs={"dropout": key})
        return jnp.sum(jnp.where(masks.transpose(0, 2, 1), jnp.sin(y),
                                 0.0)), (y, masks)

    (_, (want, wmask)), (gp, gx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(params, jnp.asarray(xs))
    enc = pe.EfficientConformerEncoder(FEAT, **kw)
    enc.load_state_dict({k[len("encoder."):]: t for k, t in
                         from_flax_variables({"params": {"encoder": params}}
                                             ).items()})
    calls = []
    cls = type(enc.encoders[2])
    orig = cls.forward_train

    def spy(self, *a):
        calls.append(a[-1])
        return orig(self, *a)

    cls.forward_train = spy
    x = _t(xs).requires_grad_(True)
    try:
        y, masks = enc.train().forward_train(x, _t(lens).long())
    finally:
        cls.forward_train = orig
    assert calls == [0, 1]
    valid = masks.transpose(1, 2)
    torch.where(valid, torch.sin(y), 0.0).sum().backward()
    np.testing.assert_array_equal(masks.numpy(), np.asarray(wmask))
    assert masks[:, 0].sum(1).tolist() == [16, 10]
    np.testing.assert_allclose(torch.where(valid, y, 0.0).detach().numpy(),
                               np.where(np.asarray(wmask).transpose(0, 2, 1),
                                        np.asarray(want), 0.0), atol=1e-5)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(gx), atol=1e-5)
    _assert_grads({"encoder." + n: p for n, p in enc.named_parameters()},
                  {"encoder": gp}, 1e-4, 2e-5)


def _model_batch(rs):
    speech = rs.standard_normal((2, 96, FEAT)).astype(np.float32)
    lens = np.asarray([96, 70], np.int32)
    text = rs.randint(1, VOCAB - 1, (2, 6)).astype(np.int32)
    tlens = np.asarray([6, 3], np.int32)
    text[1, 3:] = -1
    return speech, lens, text, tlens


@pytest.mark.parametrize("conv_norm", ["layer_norm", "batch_norm"])
def test_model_loss_and_grads_match_flax(conv_norm):
    """EfficientConformerModel.forward (streaming off, a static chunk of
    4, train mode, dropout 0; the attention decoder with a right decoder)
    == jax.value_and_grad of masr_tpu's model: loss, loss_att, loss_ctc,
    acc_att rtol 1e-5; every parameter grad rtol 1e-4 atol 2e-5. With the
    BatchNorm conv (every layer eager, batch statistics) the running
    statistics after the step == flax's mutated batch_stats, atol 1e-6."""
    enc = dict(ENC, static_chunk_size=4, cnn_module_norm=conv_norm)
    rs = np.random.RandomState(3)
    fm = build_flax_model("efficient_conformer", FEAT, VOCAB,
                          streaming=False, encoder_conf=enc,
                          decoder_conf=DEC, model_conf=MODEL_CONF)
    speech, lens, text, tlens = _model_batch(rs)
    args = [jnp.asarray(a) for a in (speech, lens, text, tlens)]
    v = jax.jit(fm.init, static_argnames=("train",))(
        {"params": jax.random.PRNGKey(0)}, *args, train=True)
    params = _perturb(v["params"], rs)
    stats = _perturb(v.get("batch_stats", {}), rs, 0.1)
    mutable = ["batch_stats"] if stats else False

    def loss(p):
        out = fm.apply({"params": p, **({"batch_stats": stats} if stats
                                         else {})}, *args, train=True,
                       rngs={"dropout": jax.random.PRNGKey(1)},
                       mutable=mutable)
        out, new = out if mutable else (out, {})
        return out["loss"], (out, new)

    (_, (want, new_stats)), gp = jax.jit(
        jax.value_and_grad(loss, has_aux=True))(params)
    port = build_model("efficient_conformer", FEAT, VOCAB, streaming=False,
                       encoder_conf=enc, decoder_conf=DEC,
                       model_conf=MODEL_CONF)
    variables = {"params": params, **({"batch_stats": stats} if stats
                                       else {})}
    missing, _ = port.load_state_dict(from_flax_variables(variables),
                                      strict=False)
    assert all(k.endswith("num_batches_tracked") for k in missing)
    out = port.train()(_t(speech), _t(lens).long(), _t(text).long(),
                       _t(tlens).long())
    out["loss"].backward()
    for k in ("loss", "loss_att", "loss_ctc", "acc_att"):
        np.testing.assert_allclose(float(out[k].detach()), float(want[k]),
                                   rtol=1e-5, err_msg=k)
    _assert_grads(port.named_parameters(), gp, 1e-4, 2e-5)
    if stats:
        got = flatten_dict(to_flax_variables(port.state_dict())
                           ["batch_stats"])
        want_s = flatten_dict(jax.device_get(new_stats["batch_stats"]))
        assert sorted(got) == sorted(want_s) and len(got) == 2 * 4
        for k in want_s:
            np.testing.assert_allclose(got[k], want_s[k], atol=1e-6,
                                       err_msg=str(k))


# --------------------------------------------------------------------------- #
# weights and bundles
# --------------------------------------------------------------------------- #
def _port_model(conv_norm="batch_norm", streaming=True):
    return build_model("efficient_conformer", FEAT, 8, streaming=streaming,
                       encoder_conf=dict(ENC, cnn_module_norm=conv_norm),
                       decoder_conf=DEC, model_conf=MODEL_CONF)


def test_weight_map_and_upstream_state_dict():
    """A seeded BatchNorm Efficient-Conformer (its default conv norm, so
    the stride layer's conv module carries batch_stats): flax → port →
    flax bit for bit; an upstream state_dict of the same weights with the
    stride layer's concat_linear and num_batches_tracked loads through
    load_upstream_state_dict into a fresh model with the same state, and
    masr_tpu's convert_efficient_conformer on it gives the same flax
    params and batch_stats with no miss; a missing name raises."""
    from masr_tpu.models.convert import convert_efficient_conformer
    model = _port_model()
    state = seeded_state_dict(model, 4)
    model.load_state_dict(state)
    variables = to_flax_variables(state)
    assert set(variables) == {"params", "batch_stats"}
    assert "conv_module" in variables["batch_stats"]["encoder"]["layer_1"]
    assert variables["params"]["encoder"]["layer_0"]["self_attn"][
        "pos_bias_u"].shape == (H, 3 * D // H)
    back = to_flax_variables(from_flax_variables(variables))
    for col in variables:
        a, b = flatten_dict(variables[col]), flatten_dict(back[col])
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    upstream = {k: t.numpy() for k, t in state.items()}
    upstream["encoder.encoders.1.concat_linear.weight"] = np.ones((D, 2 * D))
    upstream["encoder.encoders.1.concat_linear.bias"] = np.ones(D)
    fresh = load_upstream_state_dict(_port_model(), upstream)
    for k, t in state.items():
        assert torch.equal(fresh.state_dict()[k], t), k
    params, stats, misses = convert_efficient_conformer(upstream, FEAT, D,
                                                        [0, 1])
    assert misses == []
    for col, conv in (("params", params), ("batch_stats", stats)):
        a = flatten_dict(variables[col])
        assert set(conv) == set(a), col
        for k in a:
            np.testing.assert_array_equal(conv[k], a[k])
    del upstream["encoder.after_norm.bias"]
    with pytest.raises(RuntimeError, match="after_norm"):
        load_upstream_state_dict(_port_model(), upstream)


@pytest.mark.parametrize("quant", [None, "bf16", "int8"],
                         ids=["f32", "bf16", "int8"])
def test_bundle_equals_masr_tpu_export(tmp_path, quant):
    """The port's bundle of the seeded BatchNorm model == masr_tpu's of the
    same variables, the three files byte for byte; the port reads its f32
    bundle back to the same state, which masr_tpu's model reads to the
    same CTC probs (atol 1e-5 over the valid frames)."""
    from masr_tpu.infer.bundle import (load_inference_bundle as jax_load,
                                       save_inference_bundle as jax_save)
    from masr_tpu_torch.infer.bundle import (load_inference_bundle,
                                             save_inference_bundle)
    model = _port_model()
    state = seeded_state_dict(model, 5)
    vocab = ["<blank>", "<unk>", "你", "好", "天", "气", "<space>", "<eos>"]
    args = (True, FEAT, vocab, np.full(FEAT, 15.0), np.full(FEAT, 0.33),
            dict(ENC, cnn_module_norm="batch_norm"), DEC, MODEL_CONF,
            {"feature_method": "fbank", "n_mels": FEAT})
    variables = to_flax_variables(state)
    port_dir, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    save_inference_bundle(port_dir, "efficient_conformer", *args, variables,
                          quant=quant)
    jax_save(jax_dir, "efficient_conformer", *args, variables, quant=quant)
    for name in ("inference.json", "vocabulary.txt", "model.msgpack"):
        with open(os.path.join(port_dir, name), "rb") as a, \
                open(os.path.join(jax_dir, name), "rb") as b:
            assert a.read() == b.read(), name
    if quant is not None:
        return
    port, meta, _ = load_inference_bundle(port_dir)
    assert meta["use_model"] == "efficient_conformer"
    for k, t in state.items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(port.state_dict()[k], t), k
    jmodel, jv, _, _ = jax_load(port_dir)
    rs = np.random.RandomState(6)
    speech = (15.0 + 3.0 * rs.standard_normal((2, 131, FEAT))).astype(
        np.float32)
    lens = np.asarray([131, 90])
    want_p, want_l = jmodel.apply(jv, jnp.asarray(speech), jnp.asarray(lens),
                                  method=type(jmodel).get_encoder_out)
    with torch.no_grad():
        got_p, got_l = port.get_encoder_out(_t(speech), _t(lens))
    assert got_l.tolist() == np.asarray(want_l).tolist()
    for b, n in enumerate(got_l.tolist()):
        np.testing.assert_allclose(got_p[b, :n].numpy(),
                                   np.asarray(want_p)[b, :n], atol=1e-5)


def test_config_builds_at_full_width():
    """configs/efficient_conformer.yml: 12 blocks, d=256, grouped layers
    0-3 (g=3, pos_bias (4, 192)), the stride layer 3, kernels 15 then 7,
    the tail from layer 4, layer_norm conv, causal (streaming), the 3 + 3
    block decoder; an encoder_conf that also sets use_dynamic_chunk or
    causal raises TypeError in both packages."""
    from masr_tpu_torch.utils.config import load_config
    conf = load_config(os.path.join(os.path.dirname(__file__), "..",
                                    "configs", "efficient_conformer.yml"))
    model = build_model("efficient_conformer", 80, 100,
                        streaming=conf["streaming"],
                        encoder_conf=conf["encoder_conf"],
                        decoder_conf=conf["decoder_conf"],
                        model_conf=conf["model_conf"])
    enc = model.encoder
    assert len(enc.encoders) == 12 and enc.output_size == 256
    assert enc.kernels == [15, 7] and enc.tail_start == 4 and enc.causal
    assert isinstance(enc.encoders[3], pe.StrideConformerEncoderLayer)
    for i, layer in enumerate(enc.encoders):
        grouped = isinstance(layer.self_attn,
                             pe.GroupedRelPositionMultiHeadedAttention)
        assert grouped == (i < 4)
        assert tuple(layer.self_attn.pos_bias_u.shape) == \
            ((4, 192) if i < 4 else (4, 64))
        assert layer.conv_module.depthwise_conv.kernel_size == \
            ((15,) if i <= 3 else (7,))
    assert enc.downsampling_factor(3) == 1 and enc.downsampling_factor(4) == 2
    assert model.decoder.r_num_blocks == 3
    for key in ("use_dynamic_chunk", "causal"):
        bad = dict(conf["encoder_conf"], **{key: True})
        with pytest.raises(TypeError, match=key):
            build_model("efficient_conformer", 80, 100, encoder_conf=bad)
        small = dict(ENC, **{key: True})
        fm = build_flax_model("efficient_conformer", FEAT, 8,
                              encoder_conf=small)
        with pytest.raises(TypeError, match=key):
            fm.init({"params": jax.random.PRNGKey(0)},
                    jnp.zeros((1, 67, FEAT)), jnp.asarray([67]),
                    method=type(fm).get_encoder_out)


# --------------------------------------------------------------------------- #
# MASRTrainer on the CPU
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    from test_torch_training import _corpus
    return _corpus(str(tmp_path_factory.mktemp("eff_corpus")))


def _trainer_config(corpus, save_dir):
    from test_torch_training import PRE
    return {
        "encoder_conf": dict(output_size=32, attention_heads=2,
                             linear_units=32, num_blocks=3,
                             cnn_module_kernel=15,
                             cnn_module_norm="layer_norm", dropout_rate=0.1,
                             attention_dropout_rate=0.1,
                             positional_dropout_rate=0.1,
                             efficient_conf=dict(stride_layer_idx=[1],
                                                 stride=[2],
                                                 group_layer_idx=[0, 1],
                                                 group_size=3)),
        "decoder_conf": dict(attention_heads=2, linear_units=32,
                             num_blocks=1, r_num_blocks=1),
        "model_conf": MODEL_CONF,
        "dataset_conf": dict(batch_size=2, num_workers=2, min_duration=0,
                             max_duration=20,
                             train_manifest=corpus["train"],
                             test_manifest=corpus["test"],
                             dataset_vocab=corpus["vocab"],
                             mean_istd_path=corpus["cmvn"]),
        "preprocess_conf": PRE,
        "optimizer_conf": dict(optimizer="Adam", weight_decay=1e-6,
                               learning_rate=1e-3, scheduler="WarmupLR",
                               scheduler_conf=dict(warmup_steps=4,
                                                   min_lr=1e-5)),
        # configs/efficient_conformer.yml's accumulation
        "train_conf": dict(grad_clip=5.0, accum_grad=4, max_epoch=1,
                           log_interval=1),
        "ctc_beam_search_decoder_conf": dict(beam_size=4, cutoff_top_n=4,
                                             alpha=0.0, beta=0.0,
                                             language_model_path=None),
        "use_model": "efficient_conformer", "streaming": True,
        "metrics_type": "cer", "log_dir": os.path.join(save_dir, "log")}


def test_trainer_trains_evaluates_and_exports(corpus, tmp_path):
    """MASRTrainer(device="cpu") on a 3-block Efficient-Conformer (tail:
    layer 2): one epoch of 8 steps with accum_grad 4 (2 updates), finite
    losses; evaluate with ctc_greedy, ctc_beam_search, attention_rescoring
    and ctc_beam_search_device gives a finite (error, loss), the loss the
    same for every decoder; export writes a bundle whose predictor gives
    the trained model's CTC probs (atol 1e-6: the same plain twins on the
    same weights)."""
    from masr_tpu_torch.infer.inference_model import InferencePredictor
    from masr_tpu_torch.training.trainer import MASRTrainer
    save = str(tmp_path / "models")
    tr = MASRTrainer(_trainer_config(corpus, str(tmp_path)), device="cpu")
    tr.train(save_model_path=save, augment_conf_path=None)
    assert tr.state.step == 8 and tr.state.updates == 2
    with open(os.path.join(str(tmp_path), "log", "scalars.jsonl")) as f:
        losses = [json.loads(l)["value"] for l in f
                  if json.loads(l)["tag"] == "Train/Loss"]
    assert len(losses) == 8 and np.isfinite(losses).all()
    best = os.path.join(save, "efficient_conformer_streaming_fbank",
                        "best_model")
    results = {d: tr.evaluate(resume_model=best, decoder=d)
               for d in ("ctc_greedy", "ctc_beam_search",
                         "attention_rescoring", "ctc_beam_search_device")}
    for err, loss in results.values():
        assert 0.0 <= err and np.isfinite(loss)
    assert len({loss for _, loss in results.values()}) == 1
    out = tr.export(save_model_path=save, resume_model=best)
    ip = InferencePredictor(out, device="cpu")
    rs = np.random.RandomState(2)
    speech = (10.0 + 3.0 * rs.standard_normal((2, 200, 80))).astype(
        np.float32)
    lens = np.asarray([200, 150])
    probs, plens = ip.predict(speech, lens)
    tr.model.eval()
    with torch.no_grad():
        want, wlens = tr.model.get_encoder_out(_t(speech), _t(lens))
    assert plens.tolist() == wlens.tolist()
    for b, n in enumerate(plens.tolist()):
        np.testing.assert_allclose(probs[b, :n], want[b, :n].numpy(),
                                   atol=1e-6)
