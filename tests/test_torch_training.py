"""The port's training path (masr_tpu_torch: masks, label helpers, losses,
the attention decoder, ConformerModel.forward, the optimizer and train
step, the data pipeline, MASRTrainer) against masr_tpu on the same seeded
numpy inputs and weights, on the CPU; each tolerance is stated."""
import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from masr_tpu.models import losses as jl
from masr_tpu.models.decoder import BiTransformerDecoder as FlaxDecoder
from masr_tpu.models.registry import build_model as build_flax_model
from masr_tpu.ops import common as jc
from masr_tpu.ops import masks as jm
from masr_tpu.optimizer import schedulers as js
from masr_tpu_torch.models.decoder import BiTransformerDecoder
from masr_tpu_torch.models.losses import label_smoothing_loss
from masr_tpu_torch.models.registry import build_model
from masr_tpu_torch.models.weights import (from_flax_variables,
                                           grads_to_flax_variables)
from masr_tpu_torch.ops import common as tc
from masr_tpu_torch.ops import masks as tm
from masr_tpu_torch.optimizer import schedulers as ts
from masr_tpu_torch.training import train_state as tstate
from test_torch_threads import one_torch_thread  # noqa: F401


def _t(a):
    return torch.from_numpy(np.asarray(a))


# --------------------------------------------------------------------------- #
# masks and label helpers
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("size,chunk,left", [(13, 4, -1), (13, 4, 1),
                                             (20, 1, 0), (9, 25, 2)])
def test_chunk_masks_match_jax(size, chunk, left):
    """subsequent_mask and subsequent_chunk_mask == masr_tpu's, exactly."""
    np.testing.assert_array_equal(tm.subsequent_mask(size).numpy(),
                                  np.asarray(jm.subsequent_mask(size)))
    np.testing.assert_array_equal(
        tm.subsequent_chunk_mask(size, chunk, left).numpy(),
        np.asarray(jm.subsequent_chunk_mask(size, chunk, left)))


def test_add_optional_chunk_mask_matches_jax():
    """Full context, a static chunk and a decoding chunk (with left
    chunks): the (B, T, T) mask == masr_tpu's, exactly."""
    T = 17
    lens = np.asarray([17, 9, 1])
    pad = np.arange(T)[None, None, :] < lens[:, None, None]
    for args in ((False, False, 0, 0, -1), (False, False, 0, 5, -1),
                 (True, False, 4, 0, 2), (True, True, -1, 0, -1)):
        got = tm.add_optional_chunk_mask(T, _t(pad), *args)
        want = jm.add_optional_chunk_mask(T, jnp.asarray(pad), *args)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_dynamic_chunk_draw_formula():
    """The draw keeps the upstream formula (masks.py:72-87, a277a7c): chunk
    = randint[1, T), full context past T // 2, else chunk % 25 + 1;
    num_left = randint[0, max((T - 1) // chunk, 1)), high-exclusive;
    replayed here from the same generator."""
    seen_left = set()
    for T in (7, 50, 299):
        for seed in range(60):
            chunk, left = tm.draw_dynamic_chunk(
                T, True, torch.Generator().manual_seed(seed))
            g = torch.Generator().manual_seed(seed)
            draw = int(torch.randint(1, T, (), generator=g))
            if draw > T // 2:
                assert (chunk, left) == (T, -1)
                continue
            assert chunk == draw % 25 + 1
            hi = max((T - 1) // chunk, 1)
            assert left == int(torch.randint(0, hi, (), generator=g))
            assert 0 <= left < hi
            seen_left.add(left)
    assert len(seen_left) > 3


def test_label_helpers_match_jax():
    """add_sos_eos, reverse_pad_list and th_accuracy == masr_tpu's."""
    rs = np.random.RandomState(0)
    lens = np.asarray([5, 0, 3, 7])
    ys = rs.randint(1, 9, (4, 7)).astype(np.int64)
    ys[np.arange(7)[None] >= lens[:, None]] = -1
    got = tc.add_sos_eos(_t(ys), _t(lens), 10, 10)
    want = jc.add_sos_eos(jnp.asarray(ys), jnp.asarray(lens), 10, 10)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(
        tc.reverse_pad_list(_t(ys), _t(lens)).numpy(),
        np.asarray(jc.reverse_pad_list(jnp.asarray(ys), jnp.asarray(lens),
                                       -1.0)).astype(np.int64))
    logits = rs.standard_normal((4 * 8, 11)).astype(np.float32)
    tgt = rs.randint(0, 11, (4, 8))
    tgt[:, 5:] = -1
    np.testing.assert_allclose(
        float(tc.th_accuracy(_t(logits), _t(tgt))),
        float(jc.th_accuracy(jnp.asarray(logits), jnp.asarray(tgt))),
        rtol=1e-7)


@pytest.mark.parametrize("normalize", [False, True])
def test_label_smoothing_loss_matches_jax(normalize):
    """label_smoothing_loss == masr_tpu's, rtol 1e-6, padding ignored."""
    rs = np.random.RandomState(1)
    logits = rs.standard_normal((3, 6, 13)).astype(np.float32) * 2
    tgt = rs.randint(0, 13, (3, 6))
    tgt[1, 2:] = -1
    got = label_smoothing_loss(_t(logits), _t(tgt), 13, -1, 0.1, normalize)
    want = jl.label_smoothing_loss(jnp.asarray(logits), jnp.asarray(tgt), 13,
                                   -1, 0.1, normalize)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


# --------------------------------------------------------------------------- #
# the attention decoder
# --------------------------------------------------------------------------- #
def test_decoder_matches_flax():
    """BiTransformerDecoder (weights carried by from_flax_variables) ==
    the flax decoder, left and right logits, atol 2e-5 (f32)."""
    V, D, T, L = 17, 32, 11, 6
    conf = dict(attention_heads=2, linear_units=40, num_blocks=2,
                r_num_blocks=1)
    dec = FlaxDecoder(vocab_size=V, encoder_output_size=D, **conf)
    rs = np.random.RandomState(2)
    mem = rs.standard_normal((2, T, D)).astype(np.float32)
    mmask = (np.arange(T)[None, None, :] < np.asarray([11, 7])[:, None, None])
    ys = rs.randint(0, V, (2, L))
    ylens = np.asarray([6, 3])
    rys = rs.randint(0, V, (2, L))
    v = dec.init(jax.random.PRNGKey(0), jnp.asarray(mem), jnp.asarray(mmask),
                 jnp.asarray(ys), jnp.asarray(ylens), jnp.asarray(rys), 0.3)
    params = jax.tree.map(lambda l: np.asarray(l) + 0.05 * rs.standard_normal(
        l.shape).astype(np.float32), v["params"])
    want = dec.apply({"params": params}, jnp.asarray(mem), jnp.asarray(mmask),
                     jnp.asarray(ys), jnp.asarray(ylens), jnp.asarray(rys),
                     0.3)
    port = BiTransformerDecoder(V, D, dropout_rate=0.0, **conf)
    sd = from_flax_variables({"params": {"decoder": params}})
    port.load_state_dict({k[len("decoder."):]: t for k, t in sd.items()})
    with torch.no_grad():
        got = port.eval()(_t(mem), _t(mmask), _t(ys), _t(ylens), _t(rys), 0.3)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-5)


# --------------------------------------------------------------------------- #
# the whole model: loss dict and every grad
# --------------------------------------------------------------------------- #
FEAT, VOCAB = 20, 12
ENC = dict(output_size=32, attention_heads=2, linear_units=48, num_blocks=2,
           cnn_module_kernel=7, dropout_rate=0.0, positional_dropout_rate=0.0,
           attention_dropout_rate=0.0, use_dynamic_chunk=False,
           static_chunk_size=4, causal=True)
DEC = dict(attention_heads=2, linear_units=40, num_blocks=1, r_num_blocks=1,
           dropout_rate=0.0, positional_dropout_rate=0.0)
MODEL_CONF = dict(ctc_weight=0.3, lsm_weight=0.1, reverse_weight=0.3)


def _model_batch(rs):
    speech = rs.standard_normal((2, 64, FEAT)).astype(np.float32)
    lens = np.asarray([64, 45], np.int32)
    text = rs.randint(1, VOCAB - 1, (2, 6)).astype(np.int32)
    tlens = np.asarray([6, 3], np.int32)
    text[1, 3:] = -1
    return speech, lens, text, tlens


def test_model_loss_and_grads_match_flax():
    """ConformerModel.forward (train mode, dropout 0, a static chunk mask,
    the layers through the training-layer route, CTC through ctc_loss) ==
    jax.value_and_grad of masr_tpu's ConformerModel: loss, loss_att,
    loss_ctc, acc_att rtol 1e-5; every parameter grad rtol 1e-4 atol 2e-5
    (f32, other sum orders)."""
    rs = np.random.RandomState(3)
    fm = build_flax_model("conformer", FEAT, VOCAB, encoder_conf=ENC,
                          decoder_conf=DEC, model_conf=MODEL_CONF)
    speech, lens, text, tlens = _model_batch(rs)
    args = [jnp.asarray(a) for a in (speech, lens, text, tlens)]
    v = jax.jit(fm.init, static_argnames=("train",))(
        {"params": jax.random.PRNGKey(0)}, *args, train=False)
    params = jax.tree.map(lambda l: np.asarray(l) + 0.02 * rs.standard_normal(
        l.shape).astype(np.float32), v["params"])

    def loss(p):
        out = fm.apply({"params": p}, *args, train=True,
                       rngs={"dropout": jax.random.PRNGKey(1)})
        return out["loss"], out

    (_, want), gp = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    port = build_model("conformer", FEAT, VOCAB, encoder_conf=ENC,
                       decoder_conf=DEC, model_conf=MODEL_CONF)
    port.load_state_dict(from_flax_variables({"params": params}))
    out = port.train()(_t(speech), _t(lens).long(), _t(text).long(),
                       _t(tlens).long())
    out["loss"].backward()
    for k in ("loss", "loss_att", "loss_ctc", "acc_att"):
        np.testing.assert_allclose(float(out[k].detach()), float(want[k]),
                                   rtol=1e-5,
                                   err_msg=k)
    got = grads_to_flax_variables(port.named_parameters())["params"]
    flat = jax.tree_util.tree_flatten_with_path(gp)[0]
    assert len(flat) == len(jax.tree_util.tree_leaves(got))
    for path, g in flat:
        node = got
        for k in path:
            node = node[k.key]
        np.testing.assert_allclose(node, np.asarray(g), rtol=1e-4, atol=2e-5,
                                   err_msg=str(path))


def test_dynamic_chunk_training_needs_its_generator():
    """A dynamic-chunk model's loss path draws its chunk from
    chunk_generator and refuses to run without one."""
    port = build_model("conformer", FEAT, VOCAB,
                       encoder_conf=dict(ENC, use_dynamic_chunk=True),
                       decoder_conf=DEC, model_conf=MODEL_CONF)
    speech, lens, text, tlens = _model_batch(np.random.RandomState(4))
    a = (_t(speech), _t(lens).long(), _t(text).long(), _t(tlens).long())
    with pytest.raises(ValueError, match="chunk_generator"):
        port(*a)
    with torch.no_grad():
        x = port(*a, chunk_generator=torch.Generator().manual_seed(5))
        y = port(*a, chunk_generator=torch.Generator().manual_seed(5))
    assert float(x["loss"]) == float(y["loss"])


# --------------------------------------------------------------------------- #
# optimizer and train step
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("name,conf", [
    ("WarmupLR", dict(warmup_steps=10, min_lr=1e-5)),
    ("WarmupLR", dict(warmup_steps=0, min_lr=1e-4)),
    ("NoamHoldAnnealing", dict(max_steps=100)),
    ("CosineWithWarmup", dict(T_max=50))])
def test_lr_schedules_match_jax(name, conf):
    """Every schedule == masr_tpu's at steps 0..119, rtol 1e-6 atol 1e-9
    (masr_tpu evaluates them in f32, the port in f64)."""
    got = ts.build_lr_schedule(name, 2e-3, conf)
    want = js.build_lr_schedule(name, 2e-3, conf)
    for step in range(120):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6,
                                   atol=1e-9, err_msg=f"{name} step {step}")


OPT_CONF = dict(optimizer="Adam", learning_rate=1e-2, weight_decay=1e-2,
                scheduler="WarmupLR", scheduler_conf=dict(warmup_steps=2))


def _opt_case(finite_flags):
    """Six micro-steps of given grads through the port's TrainState
    (accum_grad 2, clip 0.5) and through masr_tpu's build_optimizer chain
    with its train step's non-finite rule → (port params, jax params)."""
    rs = np.random.RandomState(6)
    p0 = {"a": rs.standard_normal((3, 4)).astype(np.float32),
          "b": rs.standard_normal(5).astype(np.float32)}
    grads = [{k: (rs.standard_normal(v.shape) * 3).astype(np.float32)
              for k, v in p0.items()} for _ in finite_flags]
    tx, _ = js.build_optimizer(OPT_CONF, grad_clip=0.5, accum_grad=2)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    opt_state = tx.init(jp)
    for g, ok in zip(grads, finite_flags):
        g = {k: jnp.asarray(v) if ok else jnp.zeros_like(v)
             for k, v in g.items()}
        upd, opt_state = tx.update(g, opt_state, jp)
        new = optax.apply_updates(jp, upd)
        jp = jax.tree.map(lambda n, o: jnp.where(ok, n, o), new, jp)

    module = torch.nn.ParameterDict({k: torch.nn.Parameter(_t(v).clone())
                                     for k, v in p0.items()})
    opt, sched, _ = ts.build_optimizer(module.parameters(), OPT_CONF)
    state = tstate.TrainState(module, opt, sched, grad_clip=0.5,
                              accum_grad=2)
    names = list(module.keys())
    for g, ok in zip(grads, finite_flags):
        bad = {k: torch.full_like(_t(v), float("nan")) for k, v in g.items()}
        tstate.accumulate(state, [(_t(g[k]) if ok else bad[k])
                                  for k in names], ok)
    return ({k: module[k].detach().numpy() for k in names},
            {k: np.asarray(v) for k, v in jp.items()}, state)


def test_three_updates_with_clip_l2_and_accum_match_optax():
    """Three optimizer updates (accum_grad 2: six micro-steps) with clip
    0.5, L2 weight decay and WarmupLR == masr_tpu's optax chain on the
    same grads, rtol 1e-5 atol 1e-6."""
    got, want, state = _opt_case([True] * 6)
    assert (state.step, state.updates) == (6, 3)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6)


def test_non_finite_micro_steps_are_skipped_as_in_masr_tpu():
    """A non-finite micro-step inside an accumulation (zero grads, params
    kept) and one at a boundary (the update runs on the moments, the
    parameters stay): the parameters after six micro-steps == masr_tpu's
    rule, rtol 1e-5 atol 1e-6; no NaN reaches them."""
    got, want, state = _opt_case([True, False, True, False, True, True])
    assert (state.step, state.updates) == (6, 3)
    for k in want:
        assert np.isfinite(got[k]).all()
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6)


# --------------------------------------------------------------------------- #
# data pipeline and the trainer
# --------------------------------------------------------------------------- #
CHARS = "上家音月火少风大你下雪蓝右黑真"


def _corpus(root, n_train=16, n_test=4):
    """Synthetic speech (SyntheticTTS) with manifests, a vocabulary and
    CMVN statistics in the layout create_data writes → paths dict."""
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


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return _corpus(str(tmp_path_factory.mktemp("corpus")))


PRE = dict(feature_method="fbank", n_mels=80, sample_rate=16000,
           use_dB_normalization=True, target_dB=-20)


def test_dataset_collate_sampler_match_masr_tpu(corpus):
    """MASRDataset items, collate_fn batches and BatchShuffleSampler
    orders over three epochs == masr_tpu's (features atol 1e-5, the rest
    exactly)."""
    from masr_tpu.data.collate import collate_fn as jcollate
    from masr_tpu.data.dataset import MASRDataset as JDataset
    from masr_tpu.data.sampler import BatchShuffleSampler as JSampler
    from masr_tpu_torch.data.collate import collate_fn
    from masr_tpu_torch.data.dataset import MASRDataset
    from masr_tpu_torch.data.sampler import BatchShuffleSampler
    ours = MASRDataset(PRE, corpus["train"], corpus["vocab"])
    theirs = JDataset(PRE, corpus["train"], corpus["vocab"])
    assert len(ours) == len(theirs) == 16
    items = [ours[i] for i in range(5)]
    for i, (f, ids) in enumerate(items):
        jf, jids = theirs[i]
        np.testing.assert_allclose(f, jf, atol=1e-5)
        np.testing.assert_array_equal(ids, jids)
    got = collate_fn(items, rng=np.random.RandomState(3))
    want = jcollate(items, rng=np.random.RandomState(3))
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    a, b = BatchShuffleSampler(16, 3, seed=4), JSampler(16, 3, seed=4)
    for epoch in range(3):
        a.set_epoch(epoch)
        b.set_epoch(epoch)
        assert list(a) == list(b) and len(a) == len(b)


def _trainer_config(corpus, save_dir, max_epoch):
    return {
        "encoder_conf": dict(output_size=32, attention_heads=2,
                             linear_units=48, num_blocks=1,
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
                               learning_rate=2e-3, scheduler="WarmupLR",
                               scheduler_conf=dict(warmup_steps=4,
                                                   min_lr=1e-5)),
        "train_conf": dict(grad_clip=5.0, accum_grad=1, max_epoch=max_epoch,
                           log_interval=1),
        "use_model": "conformer", "streaming": True,
        "metrics_type": "cer", "log_dir": os.path.join(save_dir, "log")}


def test_trainer_trains_saves_and_resumes_on_cpu(corpus, tmp_path):
    """MASRTrainer(device="cpu").train: 2 epochs of 4 steps on synthetic
    speech; the loss falls (mean of the last epoch below the first step),
    epoch_1, epoch_2, last_model and best_model are written; a second
    trainer with max_epoch 3 resumes from last_model at epoch 2 and
    continues the step count to 12."""
    from masr_tpu_torch.training.trainer import MASRTrainer
    save = str(tmp_path / "models")
    tr = MASRTrainer(_trainer_config(corpus, str(tmp_path), 2), device="cpu")
    tr.train(save_model_path=save, augment_conf_path=None)
    with open(os.path.join(str(tmp_path), "log", "scalars.jsonl")) as f:
        points = [json.loads(l) for l in f]
    losses = [p["value"] for p in points if p["tag"] == "Train/Loss"]
    assert len(losses) == 8 and np.isfinite(losses).all()
    assert np.mean(losses[4:]) < losses[0]
    run = os.path.join(save, "conformer_streaming_fbank")
    for d in ("epoch_1", "epoch_2", "last_model", "best_model"):
        assert os.path.exists(os.path.join(run, d, "state.pt")), d
    tr2 = MASRTrainer(_trainer_config(corpus, str(tmp_path), 3),
                      device="cpu")
    tr2.train(save_model_path=save, augment_conf_path=None)
    assert tr2.state.step == 12
    with open(os.path.join(run, "last_model", "model.state")) as f:
        assert json.load(f)["last_epoch"] == 3
    err, loss = tr2.evaluate(resume_model=os.path.join(run, "best_model"))
    assert 0.0 <= err and np.isfinite(loss)


def test_trainer_refuses_what_is_not_ported(corpus, tmp_path):
    """Tensor-parallel training in one process raises ValueError: the one
    rank's world is not divisible by tensor_parallel (it trains under
    torchrun, tests/test_torch_tensor_parallel.py; enable_amp trains every
    family, tests/test_torch_amp_families.py); an eval decoder the trainer
    does not know raises ValueError; device="cuda" without a card raises
    (no silent CPU)."""
    from masr_tpu_torch.training.trainer import MASRTrainer
    conf = _trainer_config(corpus, str(tmp_path), 1)
    tr = MASRTrainer(conf, device="cpu")
    with pytest.raises(ValueError, match="no_such_decoder"):
        tr._resolve_eval_decoder([], "no_such_decoder")
    with pytest.raises(ValueError, match="not divisible by "
                       "tensor_parallel=2"):
        MASRTrainer(dict(conf, train_conf=dict(conf["train_conf"],
                                               tensor_parallel=2)),
                    device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            MASRTrainer(conf)
