"""bf16 training (masr_tpu's train_conf.enable_amp) of the routes that have
no training-layer kernel of their own: the BatchNorm Squeezeformer (eager
layers), the Efficient-Conformer (eager grouped and stride head, its
layer_norm tail through row 3's bf16 mode, or every layer eager with a
BatchNorm conv module) and DeepSpeech2 (torch's bf16 LSTM / GRU under
autograd), against masr_tpu at dtype=jnp.bfloat16 on the CPU, at small
widths (d 64, 4 heads, FFN 256, 3 blocks; DS2 2 layers of 48 units; B 3,
167 frames, ragged); then MASRTrainer with enable_amp on each route and
on every shipped config, shrunk.

The models' rule is tests/test_torch_bf16_training.py's (`_MODEL_ROUNDINGS`,
`_roundings`): each grad of the port's bf16 model within twice masr_tpu's
own bf16-vs-f32 move plus 28 roundings (max) and 8 (mean) of masr_tpu's
bf16 grad, the loss within one rounding, and the port's bf16 grads no
further from its f32 grads than twice masr_tpu's are. On the CPU masr_tpu
trains through its flax layers; the port's eager modules round where
flax's do (models/layers.py), but their backward (autograd's) rounds its
own way, and DeepSpeech2's recurrence is torch's bf16 LSTM / GRU, whose
cells round at other points than masr_tpu's hoisted scan (which rounds h,
c and every gate, masr_tpu/models/deepspeech2.py:64-125). Measured here
over seeds 1-3 of `_case`, every route: the loss within 0.80 roundings;
the grads' largest excess over twice masr_tpu's move 22.8 roundings (max,
the BatchNorm Squeezeformer's right decoder FFN w_1, whose grads pass the
ReLU's derivative) and 7.6 (mean, the Efficient-Conformer's right decoder),
0 for DeepSpeech2; the ratio of the two packages' bf16-vs-f32 distances
0.12-0.15 with a BatchNorm conv module (the port's bf16 grads the nearer
to f32), 0.97-1.15 for the Efficient-Conformer's tail route, 0.80-1.57
for DeepSpeech2."""
import copy
import functools
import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from flax.traverse_util import flatten_dict

import masr_tpu.models.conformer as jconf
import masr_tpu.models.efficient_conformer as jeff
import masr_tpu.models.squeezeformer as jsqm
import masr_tpu_torch.models.conformer as tconf
import masr_tpu_torch.models.efficient_conformer as teff
import masr_tpu_torch.models.squeezeformer as tsqm
from masr_tpu.models.registry import build_model as build_flax_model
from masr_tpu_torch.models.registry import build_model
from masr_tpu_torch.models.weights import (flax_like_init,
                                           from_flax_variables,
                                           grads_to_flax_variables,
                                           to_flax_variables)
from masr_tpu_torch.training.train_state import batch_to, train_step
from masr_tpu_torch.training.trainer import MASRTrainer
from masr_tpu_torch.utils.config import load_config
from test_torch_bf16_training import (CHUNK, DEC, LEFT, MODEL_CONF,
                                      _MODEL_ROUNDINGS, _amp_config,
                                      _compiled, _corpus, _leaves, _mean_rel,
                                      _perturb, _roundings)
from test_torch_threads import one_torch_thread  # noqa: F401

BF = torch.bfloat16
D, H, FF, K, B = 64, 4, 256, 7, 3
FEAT, VOCAB = 80, 20
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_EFF = dict(output_size=D, attention_heads=H, linear_units=FF, num_blocks=3,
            cnn_module_kernel=15, dropout_rate=0.0,
            positional_dropout_rate=0.0, attention_dropout_rate=0.0,
            efficient_conf=dict(stride_layer_idx=[1], stride=[2],
                                group_layer_idx=[0, 1], group_size=3))
# route → (family, encoder_conf, streaming)
ROUTES = {
    "sq_batch_norm": ("squeezeformer", dict(
        encoder_dim=D, output_size=D, attention_heads=H, num_blocks=3,
        reduce_idx=1, recover_idx=2, feed_forward_expansion_factor=FF // D,
        cnn_module_kernel=K, cnn_norm_type="batch_norm", dropout=0.0,
        input_dropout_rate=0.0, attention_dropout_rate=0.0,
        feed_forward_dropout_rate=0.0), True),
    "eff_layer_norm": ("efficient_conformer",
                       dict(_EFF, cnn_module_norm="layer_norm"), True),
    "eff_batch_norm": ("efficient_conformer",
                       dict(_EFF, cnn_module_norm="batch_norm"), True),
    "ds2_lstm": ("deepspeech2", dict(num_rnn_layers=2, rnn_size=48), True),
    "ds2_gru_bidirectional": ("deepspeech2", dict(
        num_rnn_layers=2, rnn_size=48, use_gru=True), False)}
# the running statistics after one step, port vs masr_tpu (both bf16, the
# statistics f32): each moves by 0.1 of a batch statistic taken in f32 over
# bf16 rows that the two packages round apart. Measured over seeds 1-3 of
# `_case`, both BatchNorm routes: at most 1.35 roundings (max) and 0.59
# (mean) of the statistic's own magnitude, and 3% of the step's own move
# (the largest |after - before| of masr_tpu's); held to 2, 1 and 10%
_STATS_ROUNDINGS = (2, 1)
_STATS_MOVE = 0.1


@pytest.fixture
def fixed_chunk(monkeypatch):
    """Both packages' dynamic chunk fixed to CHUNK frames with LEFT left
    chunks (each draws it from its own generator), and the Squeezeformer
    subsampling's positional dropout (0.1 in masr_tpu whatever its config)
    set to 0 in both."""
    def fixed(orig):
        def mask(xs_len, masks, dyn, dyn_left, dcs, scs, left, *a, **kw):
            return orig(xs_len, masks, dyn, dyn_left,
                        CHUNK if dyn and dcs == 0 else dcs, scs,
                        LEFT if dyn and dcs == 0 else left)
        return mask

    for mod in (jconf, tconf, jsqm, tsqm, jeff, teff):
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


def _build(route, dtype, port=True):
    family, enc, streaming = ROUTES[route]
    ds2 = family == "deepspeech2"
    kw = dict(streaming=streaming, encoder_conf=enc,
              decoder_conf=None if ds2 else DEC,
              model_conf=None if ds2 else MODEL_CONF)
    if port:
        return build_model(family, FEAT, VOCAB, dtype=dtype, **kw)
    return build_flax_model(family, FEAT, VOCAB, dtype=dtype, **kw)


def _case(route, seed):
    """The port's flax-like init of the model, every parameter perturbed
    (and every BatchNorm statistic), in masr_tpu's layout, and a batch (B
    3, 167 frames: T' 41; ragged)."""
    rs = np.random.RandomState(seed)
    speech = rs.standard_normal((B, 167, FEAT)).astype(np.float32)
    lens = np.asarray([167, 140, 100], np.int32)
    text = rs.randint(1, VOCAB - 1, (B, 6)).astype(np.int32)
    tlens = np.asarray([6, 4, 3], np.int32)
    text[1, 4:] = -1
    text[2, 3:] = -1
    port = _build(route, torch.float32)
    flax_like_init(port, torch.Generator().manual_seed(seed))
    v = to_flax_variables(port.state_dict())
    v = dict(v, params=_perturb(v["params"], seed))
    if "batch_stats" in v:
        v["batch_stats"] = _perturb(v["batch_stats"], seed + 100, 0.1)
    return v, [jnp.asarray(a) for a in (speech, lens, text, tlens)]


def _masr_tpu_step(route, v, args):
    """jax.value_and_grad of masr_tpu's model at bf16 in train mode →
    ((loss, new batch_stats or {}), grads)."""
    fm = _build(route, jnp.bfloat16, port=False)
    stats = v.get("batch_stats")

    def loss(p, *a):
        out = fm.apply({"params": p, **({"batch_stats": stats}
                                         if stats else {})}, *a, train=True,
                       rngs={"dropout": jax.random.PRNGKey(1),
                             "chunk": jax.random.PRNGKey(2)},
                       mutable=["batch_stats"] if stats else False)
        out, new = out if stats else (out, {})
        return out["loss"], new

    fn = jax.value_and_grad(loss, has_aux=True)
    return _compiled(fn, v["params"], *args)(v["params"], *args)


def _port_step(route, v, args, dtype):
    """The port's model at dtype in train mode, loss.backward() → (loss,
    grads in masr_tpu's layout, batch_stats after the step or None)."""
    port = _build(route, dtype)
    missing, unexpected = port.load_state_dict(from_flax_variables(v),
                                               strict=False)
    assert all(k.endswith("num_batches_tracked") for k in missing)
    assert not unexpected
    speech, lens, text, tlens = (torch.from_numpy(np.asarray(a))
                                 for a in args)
    out = port.train()(speech, lens.long(), text.long(), tlens.long(),
                       generator=torch.Generator().manual_seed(5),
                       chunk_generator=torch.Generator().manual_seed(6))
    assert out["loss"].dtype == torch.float32
    out["loss"].backward()
    return (float(out["loss"].detach()),
            grads_to_flax_variables(port.named_parameters())["params"],
            to_flax_variables(port.state_dict()).get("batch_stats"))


@pytest.mark.parametrize("route", list(ROUTES))
def test_bf16_loss_and_grads_match_masr_tpu(fixed_chunk, route):
    """The bf16 model's loss and every parameter grad (f32, as the
    parameters) against jax.value_and_grad of masr_tpu's model at
    dtype=bf16 (seed 1), by the module docstring's rule; with a BatchNorm
    conv module the running statistics after the step (f32) against
    masr_tpu's mutated batch_stats within _STATS_ROUNDINGS. The attention
    key biases are left out (their true grad is 0: both packages' values
    are rounding noise)."""
    v, args = _case(route, 1)
    (jl, jnew), jg = _masr_tpu_step(route, v, args)
    tl, tg, tstats = _port_step(route, v, args, BF)
    _, tg32, _ = _port_step(route, v, args, torch.float32)
    paths = [jax.tree_util.keystr(p)
             for p, _ in jax.tree_util.tree_flatten_with_path(jg)[0]]
    keep = [i for i, p in enumerate(paths)
            if not ("linear_k" in p and "bias" in p)]
    want = [jax.tree.leaves(jg)[i] for i in keep]
    got = [_leaves(tg, jg)[i] for i in keep]
    f32 = [_leaves(tg32, jg)[i] for i in keep]
    assert abs(tl - float(jl)) <= 2 ** -8 * abs(float(jl)), (tl, float(jl))
    n_max, n_mean = _MODEL_ROUNDINGS
    for i, g, w, r in zip(keep, got, want, f32):
        (e_max, e_mean), (r_max, r_mean) = _roundings(g, w), _roundings(w, r)
        assert e_max <= 2 * r_max + n_max, (paths[i], e_max, r_max)
        assert e_mean <= 2 * r_mean + n_mean, (paths[i], e_mean, r_mean)
    assert _mean_rel(got, f32) <= 2 * _mean_rel(want, f32)
    if "batch_stats" not in v:
        assert tstats is None
        return
    got_s = flatten_dict(tstats)
    want_s = flatten_dict(jax.device_get(jnew["batch_stats"]))
    assert sorted(got_s) == sorted(want_s)
    before = flatten_dict(v["batch_stats"])
    for k in want_s:
        got_k, want_k = np.asarray(got_s[k]), np.asarray(want_s[k])
        assert got_k.dtype == np.float32
        e_max, e_mean = _roundings(got_k, want_k)
        assert e_max <= _STATS_ROUNDINGS[0] and \
            e_mean <= _STATS_ROUNDINGS[1], (k, e_max, e_mean)
        move = np.abs(want_k - np.asarray(before[k])).max()
        assert move > 0 and np.abs(got_k - want_k).max() <= \
            _STATS_MOVE * move, k


# --------------------------------------------------------------------------- #
# MASRTrainer with enable_amp
# --------------------------------------------------------------------------- #
_TINY = {
    "sq_batch_norm": ("squeezeformer", dict(
        encoder_dim=32, output_size=32, attention_heads=2, num_blocks=3,
        reduce_idx=1, recover_idx=2, feed_forward_expansion_factor=2,
        cnn_module_kernel=7, cnn_norm_type="batch_norm")),
    "eff_layer_norm": ("efficient_conformer", dict(
        output_size=32, attention_heads=2, linear_units=48, num_blocks=3,
        cnn_module_kernel=15, cnn_module_norm="layer_norm",
        efficient_conf=dict(stride_layer_idx=[1], stride=[2],
                            group_layer_idx=[0, 1], group_size=3))),
    "ds2_lstm": ("deepspeech2", dict(num_rnn_layers=2, rnn_size=32))}


@pytest.mark.parametrize("route", list(_TINY))
def test_trainer_enable_amp_trains_resumes_evaluates_exports(tmp_path,
                                                             route):
    """MASRTrainer(device="cpu") with train_conf.enable_amp on each route:
    the model computes in bf16 with f32 parameters (and f32 BatchNorm
    statistics); 2 epochs of 2 steps on synthetic speech, the losses
    finite, the second epoch's mean below the first step's; a third epoch
    resumes from last_model (6 steps); `evaluate` decodes the bf16 model;
    `export` writes the f32 parameters (and batch_stats), and the bundle,
    loaded with dtype=bf16, gives the trained bf16 model's CTC
    probabilities exactly."""
    from masr_tpu_torch.infer.inference_model import InferencePredictor
    family, enc = _TINY[route]
    corpus = _corpus(str(tmp_path / "corpus"))
    save = str(tmp_path / "models")

    def config(epochs):
        conf = _amp_config(corpus, str(tmp_path), epochs, family, enc)
        if family == "deepspeech2":
            conf["decoder_conf"], conf["model_conf"] = {}, {}
        return conf

    tr = MASRTrainer(config(2), device="cpu")
    tr.train(save_model_path=save, augment_conf_path=None)
    model = tr.model
    assert model.encoder.compute_dtype == BF
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert all(b.dtype in (torch.float32, torch.int64)
               for b in model.buffers())
    with open(os.path.join(str(tmp_path), "log", "scalars.jsonl")) as f:
        points = [json.loads(l) for l in f]
    losses = [p["value"] for p in points if p["tag"] == "Train/Loss"]
    assert len(losses) == 4 and np.isfinite(losses).all(), losses
    assert np.mean(losses[2:]) < losses[0], losses
    run = os.path.join(save, f"{family}_streaming_fbank")
    tr2 = MASRTrainer(config(3), device="cpu")
    tr2.train(save_model_path=save, augment_conf_path=None)
    assert tr2.state.step == 6
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


def _shrunk(name, norm):
    """configs/<name>.yml with its widths and depth cut (its structure
    kept: the Squeezeformer's reduce and recover, the Efficient-Conformer's
    stride and groups, DS2's cell), the conv norm set to `norm` where the
    family has one, and enable_amp on."""
    conf = copy.deepcopy(dict(load_config(os.path.join(ROOT, "configs",
                                                       name + ".yml"))))
    enc = dict(conf.get("encoder_conf") or {})
    family = conf["use_model"]
    if family == "deepspeech2":
        enc.update(num_rnn_layers=2, rnn_size=32)
    else:
        enc.update(output_size=32, attention_heads=2, num_blocks=3,
                   cnn_module_kernel=7)
        conf["decoder_conf"] = dict(conf["decoder_conf"], attention_heads=2,
                                    linear_units=32, num_blocks=1,
                                    r_num_blocks=1)
    if family == "squeezeformer":
        enc.update(encoder_dim=32, feed_forward_expansion_factor=2,
                   reduce_idx=1, recover_idx=2, cnn_norm_type=norm)
    elif family != "deepspeech2":
        enc.update(linear_units=48)
    if family == "efficient_conformer":
        enc.update(num_blocks=5, cnn_module_kernel=15, cnn_module_norm=norm)
    conf["encoder_conf"] = enc
    conf["train_conf"] = dict(conf["train_conf"], enable_amp=True)
    return conf


@pytest.mark.parametrize("name,norm", [
    ("conformer", None), ("english_example", None), ("deepspeech2", None),
    ("squeezeformer", "batch_norm"), ("squeezeformer", "layer_norm"),
    ("efficient_conformer", "layer_norm"),
    ("efficient_conformer", "batch_norm")])
def test_every_config_trains_with_enable_amp(tmp_path, name, norm):
    """Every shipped config, shrunk (_shrunk), builds in MASRTrainer with
    enable_amp and takes CPU train steps on a seeded batch up to its first
    update (the config's accum_grad): the compute dtype bf16, the
    parameters f32, the losses finite f32, the parameters moved (and a
    BatchNorm's running statistics)."""
    conf = _shrunk(name, norm)
    cmvn = str(tmp_path / "mean_istd.json")
    with open(cmvn, "w", encoding="utf-8") as f:
        json.dump({"mean": [10.0] * FEAT, "istd": [0.3] * FEAT}, f)
    conf["dataset_conf"] = dict(conf["dataset_conf"], mean_istd_path=cmvn)
    conf["preprocess_conf"] = dict(conf["preprocess_conf"], n_mels=FEAT)
    tr = MASRTrainer(conf, device="cpu")
    model = tr._setup_model(FEAT, VOCAB)
    assert model.encoder.compute_dtype == BF
    assert all(p.dtype == torch.float32 for p in model.parameters())
    before = {k: t.clone() for k, t in model.state_dict().items()}
    rs = np.random.RandomState(3)
    batch = {"inputs": 10 + rs.standard_normal((2, 96, FEAT)).astype(
                 np.float32),
             "input_lens": np.asarray([96, 70], np.int32),
             "labels": np.asarray([[3, 4, 5, 6], [7, 8, -1, -1]], np.int32),
             "label_lens": np.asarray([4, 2], np.int32)}
    for _ in range(tr.state.accum_grad):
        metrics = train_step(tr.state, batch_to(batch, "cpu"), 0)
        assert metrics["finite"] and np.isfinite(metrics["loss"]), metrics
    after = model.state_dict()
    moved = [k for k in before if not torch.equal(before[k], after[k])]
    assert any(k.endswith("weight") for k in moved)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    if norm == "batch_norm":
        assert any(k.endswith("running_var") for k in moved)
