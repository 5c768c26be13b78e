"""The port's Squeezeformer training against masr_tpu on the CPU, part 2:

- SqueezeformerEncoder.forward_train (4 blocks, reduce 1, recover 3, both
  conv norms, dropout 0): output and input grad against masr_tpu's
  encoder with train=True, through reduce / recover;
- flax_like_init: every parameter's initializer family, name by name,
  against a flax-initialised model, for both families (the Conformer and
  the Squeezeformer);
- a tiny MASRTrainer run on a Squeezeformer config for each conv norm
  (layer_norm: the training-layer route; the BatchNorm default: the eager
  layers): finite loss, resume restores the parameters and the BatchNorm
  statistics, and the trained weights' inference bundle predicts the eval
  path's CTC probs.
Each tolerance is stated where it is used."""
import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import masr_tpu.models.squeezeformer as jsq
import masr_tpu_torch.models.squeezeformer as tsq
from masr_tpu.models.registry import build_model as build_flax_model
from masr_tpu_torch.models.registry import build_model
from masr_tpu_torch.models.weights import (flax_like_init,
                                           from_flax_variables,
                                           to_flax_variables)
from test_torch_sq_training import (ENC, FEAT, MODEL_CONF, _perturb, _t,
                                    deterministic)  # noqa: F401 (fixture)
from test_torch_threads import one_torch_thread  # noqa: F401


# --------------------------------------------------------------------------- #
# the encoder through reduce / recover
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("conv_norm", ["layer_norm", "batch_norm"])
def test_encoder_forward_train_matches_flax_through_reduce_recover(
        deterministic, conv_norm):
    """SqueezeformerEncoder.forward_train (4 blocks, reduce 1, recover 3,
    causal, `stream` reduction, the dynamic chunk fixed, dropout 0) ==
    masr_tpu's SqueezeformerEncoder with train=True: output over the valid
    frames and the grad of sum(sin(out)) there wrt the input features, atol
    2e-5 (post-norm rows of magnitude ~3, f32 in other sum orders)."""
    kw = dict(ENC, num_blocks=4, reduce_idx=1, recover_idx=3,
              cnn_norm_type=conv_norm, causal=True,
              time_reduction_layer_type="stream", use_dynamic_chunk=True)
    rs = np.random.RandomState(8)
    xs = rs.standard_normal((2, 67, FEAT)).astype(np.float32)
    lens = np.asarray([67, 51], np.int32)
    fenc = jsq.SqueezeformerEncoder(input_size=FEAT, **kw)
    key = jax.random.PRNGKey(0)
    v = fenc.init({"params": key, "dropout": key, "chunk": key},
                  jnp.asarray(xs), jnp.asarray(lens), train=False)
    v = _perturb(dict(v), 9)
    mutable = ["batch_stats"] if "batch_stats" in v else False

    def loss(x):
        out = fenc.apply(v, x, jnp.asarray(lens), train=True,
                         rngs={"dropout": key, "chunk": key},
                         mutable=mutable)
        y, masks = out[0] if mutable else out
        return jnp.sum(jnp.where(masks.transpose(0, 2, 1), jnp.sin(y),
                                 0.0)), (y, masks)

    (_, (want, wmask)), gx = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        jnp.asarray(xs))
    enc = tsq.SqueezeformerEncoder(FEAT, **kw)
    sd = {k[len("encoder."):]: t for k, t in from_flax_variables(
        {c: {"encoder": t} for c, t in v.items()}).items()}
    missing, unexpected = enc.load_state_dict(sd, strict=False)
    assert not unexpected
    assert all(k.endswith("num_batches_tracked") for k in missing)
    x = _t(xs).requires_grad_(True)
    y, masks = enc.train().forward_train(x, _t(lens).long(),
                                         chunk_generator=torch.Generator())
    valid = masks.transpose(1, 2)
    torch.where(valid, torch.sin(y), 0.0).sum().backward()
    np.testing.assert_array_equal(masks.numpy(), np.asarray(wmask))
    np.testing.assert_allclose(torch.where(valid, y, 0.0).detach().numpy(),
                               np.where(np.asarray(wmask).transpose(0, 2, 1),
                                        np.asarray(want), 0.0), atol=2e-5)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(gx), atol=2e-5)


# --------------------------------------------------------------------------- #
# initializer families
# --------------------------------------------------------------------------- #
def _family(a):
    """ones, zeros, or the random family whose variance is nearest (log
    scale): lecun_normal 1/fan_in, xavier_uniform 2/(fan_in + fan_out)
    (2-D), normal 1; a in the port's (torch) layout, fan_in = the product
    of the dims after the first."""
    a = np.asarray(a, np.float64)
    if np.all(a == 1.0):
        return "ones"
    if np.all(a == 0.0):
        return "zeros"
    fan_in = int(np.prod(a.shape[1:])) if a.ndim >= 2 else a.size
    cands = {"lecun_normal": 1.0 / fan_in, "normal": 1.0}
    if a.ndim == 2:
        cands["xavier_uniform"] = 2.0 / (a.shape[0] + a.shape[1])
    return min(cands, key=lambda k: abs(np.log(a.var() / cands[k])))


@pytest.mark.parametrize("family", ["conformer", "squeezeformer"])
def test_flax_like_init_families_match_flax(family):
    """Every parameter of the port's model after flax_like_init starts from
    the initializer family masr_tpu's flax model starts it from, name by
    name (ones, zeros, lecun_normal, xavier_uniform, normal), at D=64 so
    the variances tell the random families apart; the Squeezeformer's
    preln scale and every AdaptiveScale scale start at 1 and shift at 0."""
    if family == "conformer":
        enc = dict(output_size=64, attention_heads=2, linear_units=128,
                   num_blocks=2, cnn_module_kernel=7)
    else:
        enc = dict(encoder_dim=64, output_size=64, attention_heads=2,
                   num_blocks=3, reduce_idx=1, recover_idx=2,
                   feed_forward_expansion_factor=2, cnn_module_kernel=7)
    dec = dict(attention_heads=2, linear_units=64, num_blocks=1,
               r_num_blocks=1)
    fm = build_flax_model(family, 80, 50, streaming=True, encoder_conf=enc,
                          decoder_conf=dec, model_conf=MODEL_CONF)
    key = jax.random.PRNGKey(0)
    v = jax.jit(fm.init, static_argnames=("train",))(
        {"params": key, "dropout": key, "chunk": key},
        jnp.zeros((2, 67, 80)), jnp.asarray([67, 67]),
        jnp.ones((2, 4), jnp.int32), jnp.asarray([4, 4]), train=False)
    want = from_flax_variables({"params": v["params"]})
    port = build_model(family, 80, 50, streaming=True, encoder_conf=enc,
                       decoder_conf=dec, model_conf=MODEL_CONF)
    flax_like_init(port, torch.Generator().manual_seed(0))
    got = dict(port.named_parameters())
    assert set(got) == set(want)
    mismatched = {n: (_family(want[n]), _family(p.detach()))
                  for n, p in got.items()
                  if _family(want[n]) != _family(p.detach())}
    assert not mismatched, mismatched
    if family == "squeezeformer":
        ones = [n for n in got if n.endswith("ada_scale")
                or n == "encoder.preln.weight"]
        assert len(ones) == 1 + 4 * 3
        assert all(_family(got[n].detach()) == "ones" for n in ones)


# --------------------------------------------------------------------------- #
# MASRTrainer on the CPU
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    from test_torch_training import _corpus
    return _corpus(str(tmp_path_factory.mktemp("sq_corpus")))


def _trainer_config(corpus, save_dir, max_epoch, conv_norm):
    from test_torch_training import PRE
    return {
        "encoder_conf": dict(encoder_dim=32, output_size=32,
                             attention_heads=2, num_blocks=3, reduce_idx=1,
                             recover_idx=2, feed_forward_expansion_factor=2,
                             cnn_module_kernel=7, cnn_norm_type=conv_norm,
                             dropout=0.1, input_dropout_rate=0.1,
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
        # configs/squeezeformer.yml's optimizer and schedule, shortened
        "optimizer_conf": dict(optimizer="AdamW", weight_decay=4e-5,
                               learning_rate=2e-3,
                               scheduler="NoamHoldAnnealing",
                               scheduler_conf=dict(max_steps=16,
                                                   warmup_ratio=0.2,
                                                   hold_ratio=0.3,
                                                   decay_rate=1.0,
                                                   min_lr=1e-5)),
        "train_conf": dict(grad_clip=5.0, accum_grad=1, max_epoch=max_epoch,
                           log_interval=1),
        "use_model": "squeezeformer", "streaming": True,
        "metrics_type": "cer", "log_dir": os.path.join(save_dir, "log")}


def _write_bundle(path, conf, model, corpus):
    """The trained state as a masr_tpu inference bundle (flax msgpack)."""
    from masr_tpu_torch.infer import flax_msgpack
    with open(corpus["cmvn"]) as f:
        cmvn = json.load(f)
    with open(corpus["vocab"], encoding="utf-8") as f:
        vocab = [l.rstrip("\n") for l in f]
    meta = {"framework": "masr_tpu", "use_model": "squeezeformer",
            "streaming": True, "input_dim": 80, "vocab_size": len(vocab),
            "mean": cmvn["mean"], "istd": cmvn["istd"],
            "encoder_conf": conf["encoder_conf"],
            "decoder_conf": conf["decoder_conf"],
            "model_conf": conf["model_conf"],
            "preprocess_conf": conf["preprocess_conf"], "quantization": None}
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "inference.json"), "w",
              encoding="utf-8") as f:
        json.dump(meta, f, ensure_ascii=False)
    with open(os.path.join(path, "vocabulary.txt"), "w",
              encoding="utf-8") as f:
        f.writelines(t + "\n" for t in vocab)
    with open(os.path.join(path, "model.msgpack"), "wb") as f:
        f.write(flax_msgpack.packb(to_flax_variables(model.state_dict())))


@pytest.mark.parametrize("conv_norm", ["layer_norm", "batch_norm"])
def test_trainer_trains_resumes_and_serves_on_cpu(corpus, tmp_path,
                                                  conv_norm):
    """MASRTrainer(device="cpu").train on a Squeezeformer config (AdamW,
    NoamHoldAnnealing): one epoch of 4 steps, every loss finite; a second
    trainer resumes from last_model with every parameter and BatchNorm
    statistic equal to the first's (the statistics moved off their init);
    an inference bundle of the trained weights, loaded by the predictor,
    gives the eval path's CTC probs over the valid frames (atol 1e-5: the
    predictor pads the features to its 200-frame bucket)."""
    from masr_tpu_torch.infer.inference_model import InferencePredictor
    from masr_tpu_torch.training.train_state import batch_to, eval_step
    from masr_tpu_torch.training.trainer import MASRTrainer
    save = str(tmp_path / "models")
    conf = _trainer_config(corpus, str(tmp_path), 1, conv_norm)
    tr = MASRTrainer(conf, device="cpu")
    tr.train(save_model_path=save, augment_conf_path=None)
    with open(os.path.join(str(tmp_path), "log", "scalars.jsonl")) as f:
        losses = [json.loads(l)["value"] for l in f
                  if json.loads(l)["tag"] == "Train/Loss"]
    assert len(losses) == 4 and np.isfinite(losses).all()
    trained = tr.model.state_dict()
    norms = [k for k in trained if k.endswith("running_var")]
    assert len(norms) == (3 if conv_norm == "batch_norm" else 0)
    for k in norms:
        assert not torch.equal(trained[k], torch.ones_like(trained[k]))

    tr2 = MASRTrainer(conf, device="cpu")
    tr2.train(save_model_path=save, augment_conf_path=None)
    assert tr2.state.step == 4
    resumed = tr2.model.state_dict()
    assert set(resumed) == set(trained)
    for k in trained:
        assert torch.equal(resumed[k], trained[k]), k

    bundle = str(tmp_path / "bundle")
    _write_bundle(bundle, conf, tr.model, corpus)
    ds, _, loader = tr._setup_dataloader(False)
    batch = next(iter(loader))
    _, probs, lens = eval_step(tr.model, batch_to(batch, "cpu"))
    pred = InferencePredictor(bundle, device="cpu")
    p2, l2 = pred.predict(batch["inputs"], batch["input_lens"])
    np.testing.assert_array_equal(l2, lens.numpy())
    for b, n in enumerate(lens.tolist()):
        np.testing.assert_allclose(p2[b, :n], probs[b, :n].numpy(),
                                   atol=1e-5, rtol=0)
