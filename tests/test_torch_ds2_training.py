"""DeepSpeech2 training in the port against masr_tpu on the CPU: the loss
and every grad against jax.value_and_grad of masr_tpu's model, with the
port's CTC loss through row 4's plain twin (ops/cuda/ctc_loss.py on a CPU
tensor) and masr_tpu's through its CPU route; the full-width config; a
tiny MASRTrainer run with resume, every eval decoder, export (the bundle
byte for byte masr_tpu's of the same weights) and the export, eval and
train CLIs (the train CLI with its default augmentation config).

Tolerances: loss rtol 1e-5; grads rtol 1e-4 atol 2e-5 (as the other
families' tests); a trained model's bundle probs atol 1e-6 (the same
twins on the same weights).
"""
import json
import logging
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from flax.traverse_util import flatten_dict

from masr_tpu.models import deepspeech2 as jd
from masr_tpu_torch.models.registry import build_model
from masr_tpu_torch.models.weights import (from_flax_variables,
                                           grads_to_flax_variables,
                                           seeded_state_dict,
                                           to_flax_variables)
from test_torch_threads import one_torch_thread  # noqa: F401

FEAT, VOCAB = 16, 12
FORMS = [(False, True), (True, True), (False, False), (True, False)]
FORM_IDS = ["lstm-forward", "gru-forward", "lstm-bidirect", "gru-bidirect"]
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _batch(rs):
    speech = rs.standard_normal((3, 90, FEAT)).astype(np.float32)
    lens = np.asarray([90, 71, 40], np.int32)
    text = rs.randint(1, VOCAB - 1, (3, 5)).astype(np.int32)
    tlens = np.asarray([5, 3, 2], np.int32)
    text[1, 3:] = -1
    text[2, 2:] = -1
    return speech, lens, text, tlens


@pytest.mark.parametrize("use_gru,streaming", FORMS, ids=FORM_IDS)
def test_loss_and_grads_match_flax(use_gru, streaming):
    """DeepSpeech2Model.forward in train mode == jax.value_and_grad of
    masr_tpu's: loss, loss_ctc (loss_att and acc_att 0), and every
    parameter's grad mapped to the flax tree; the biases flax's cells lack
    get no grad."""
    enc = dict(num_rnn_layers=2, rnn_size=24, use_gru=use_gru)
    rs = np.random.RandomState(4)
    fm = jd.DeepSpeech2Model(input_dim=FEAT, vocab_size=VOCAB,
                             streaming=streaming, encoder_conf=enc)
    speech, lens, text, tlens = _batch(rs)
    args = [jnp.asarray(a) for a in (speech, lens, text, tlens)]
    v = jax.jit(fm.init)({"params": jax.random.PRNGKey(0)}, *args)
    params = jax.tree.map(lambda l: np.asarray(l) + 0.05 * rs.standard_normal(
        l.shape).astype(np.float32), v["params"])

    def loss(p):
        out = fm.apply({"params": p}, *args, train=True)
        return out["loss"], out

    (_, want), gp = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    port = build_model("deepspeech2", FEAT, VOCAB, streaming=streaming,
                       encoder_conf=enc)
    port.load_state_dict(from_flax_variables({"params": params}))
    out = port.train()(_t(speech), _t(lens).long(), _t(text).long(),
                       _t(tlens).long())
    out["loss"].backward()
    for k in ("loss", "loss_ctc"):
        np.testing.assert_allclose(float(out[k].detach()), float(want[k]),
                                   rtol=1e-5, err_msg=k)
    assert float(out["loss_att"]) == float(out["acc_att"]) == 0.0
    got = flatten_dict(grads_to_flax_variables(port.named_parameters())
                       ["params"])
    flat = flatten_dict(jax.device_get(gp))
    assert sorted(got) == sorted(flat)
    for k, g in flat.items():
        np.testing.assert_allclose(got[k], np.asarray(g), rtol=1e-4,
                                   atol=2e-5, err_msg=str(k))
    rnn = port.encoder.rnns[0].rnn
    if use_gru:
        assert not rnn.bias_hh_l0.grad[:48].any()
        assert rnn.bias_hh_l0.grad[48:].abs().max() > 1e-4
    else:
        assert not rnn.bias_ih_l0.grad.any()


def test_ctc_runs_row_4_plain_twin_on_the_cpu():
    """The DS2 loss goes through the CTC wrapper (ops/cuda/ctc_loss.py),
    which takes its plain twin on a CPU tensor: no kernel launch is
    counted."""
    from masr_tpu_torch.ops.cuda import ctc_loss as C
    port = build_model("deepspeech2", FEAT, VOCAB,
                       encoder_conf=dict(num_rnn_layers=1, rnn_size=16))
    speech, lens, text, tlens = _batch(np.random.RandomState(5))
    calls, orig = [], C.ctc_loss_plain

    def spy(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    C.ctc_loss_plain = spy
    try:
        launches = C.ctc_loss.launches
        port.train()(_t(speech), _t(lens).long(), _t(text).long(),
                     _t(tlens).long())["loss"].backward()
    finally:
        C.ctc_loss_plain = orig
    assert calls and C.ctc_loss.launches == launches


def test_config_builds_at_full_width():
    """configs/deepspeech2.yml: 5 LSTM layers of 1024, forward when
    streaming (~45 M parameters at V=4000 with fbank 80), bidirectional
    when not, and a GRU twin; the flax tree of each has masr_tpu's leaf
    shapes, and flax_like_init draws the recurrent kernels orthogonal per
    gate."""
    import yaml
    from masr_tpu_torch.models.weights import flax_like_init
    with open(os.path.join(ROOT, "configs", "deepspeech2.yml"),
              encoding="utf-8") as f:
        conf = yaml.safe_load(f)
    for streaming, gru, n in ((True, False, 45.0), (False, False, 123.0),
                              (True, True, 35.0)):
        enc = dict(conf["encoder_conf"], use_gru=gru)
        model = build_model("deepspeech2", 80, 4000, streaming=streaming,
                            encoder_conf=enc,
                            decoder_conf=conf["decoder_conf"])
        count = sum(p.numel() for p in model.parameters())
        assert abs(count / 1e6 - n) < 1.0, (streaming, gru, count)
        fm = jd.DeepSpeech2Model(input_dim=80, vocab_size=4000,
                                 streaming=streaming, encoder_conf=enc)
        shapes = jax.eval_shape(
            fm.init, {"params": jax.random.PRNGKey(0)},
            jnp.zeros((1, 67, 80)), jnp.asarray([67]),
            jnp.ones((1, 3), jnp.int32), jnp.asarray([3]))
        want = {k: tuple(s.shape) for k, s in
                flatten_dict(shapes["params"]).items()}
        got = {k: a.shape for k, a in flatten_dict(
            to_flax_variables(model.state_dict())["params"]).items()}
        assert got == want
    flax_like_init(model, torch.Generator().manual_seed(0))
    w = model.encoder.rnns[1].rnn.weight_hh_l0[:1024]
    eye = w @ w.T
    assert torch.allclose(eye, torch.eye(1024), atol=1e-4)
    assert not model.encoder.rnns[1].rnn.bias_hh_l0.any()


@pytest.mark.parametrize("quant", [None, "bf16", "int8"],
                         ids=["f32", "bf16", "int8"])
def test_bundle_equals_masr_tpu_export(tmp_path, quant):
    """The port's bundle of a seeded DS2 == masr_tpu's of the same
    variables, the three files byte for byte; masr_tpu reads it into its
    model and gives the port's probs (atol 1e-5)."""
    from masr_tpu.infer.bundle import (load_inference_bundle as jax_load,
                                       save_inference_bundle as jax_save)
    from masr_tpu_torch.infer.bundle import (load_inference_bundle,
                                             save_inference_bundle)
    enc = dict(num_rnn_layers=2, rnn_size=24)
    model = build_model("deepspeech2", 80, 8, encoder_conf=enc)
    state = seeded_state_dict(model, 5)
    vocab = ["<blank>", "<unk>", "你", "好", "天", "气", "<space>", "<eos>"]
    args = (True, 80, vocab, np.full(80, 15.0), np.full(80, 0.33), enc, {},
            {}, {"feature_method": "fbank", "n_mels": 80})
    variables = to_flax_variables(state)
    port_dir, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    save_inference_bundle(port_dir, "deepspeech2", *args, variables,
                          quant=quant)
    jax_save(jax_dir, "deepspeech2", *args, variables, quant=quant)
    for name in ("inference.json", "vocabulary.txt", "model.msgpack"):
        with open(os.path.join(port_dir, name), "rb") as a, \
                open(os.path.join(jax_dir, name), "rb") as b:
            assert a.read() == b.read(), name
    if quant is not None:
        return
    port, meta, _ = load_inference_bundle(port_dir)
    for k, t in state.items():
        assert torch.equal(port.state_dict()[k], t), k
    jmodel, jv, _, _ = jax_load(port_dir)
    rs = np.random.RandomState(6)
    speech = (15.0 + 3.0 * rs.standard_normal((2, 131, 80))).astype(
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


# --------------------------------------------------------------------------- #
# MASRTrainer and the CLIs on the CPU
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    from test_torch_training import _corpus
    return _corpus(str(tmp_path_factory.mktemp("ds2_corpus")), n_train=8,
                   n_test=4)


def _trainer_config(corpus, save_dir, max_epoch=2, use_gru=False):
    from test_torch_training import PRE
    return {
        "encoder_conf": dict(num_rnn_layers=2, rnn_size=32,
                             use_gru=use_gru),
        "decoder_conf": {},
        "dataset_conf": dict(batch_size=2, num_workers=2, min_duration=0,
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
        "train_conf": dict(grad_clip=5.0, accum_grad=1,
                           max_epoch=max_epoch, log_interval=1),
        "ctc_beam_search_decoder_conf": dict(beam_size=4, cutoff_top_n=4,
                                             alpha=0.0, beta=0.0,
                                             language_model_path=None),
        "use_model": "deepspeech2", "streaming": True, "decoder":
        "attention_rescoring", "metrics_type": "cer",
        "log_dir": os.path.join(save_dir, "log")}


def _losses(log_dir):
    with open(os.path.join(log_dir, "scalars.jsonl")) as f:
        return [json.loads(l)["value"] for l in f
                if json.loads(l)["tag"] == "Train/Loss"]


def test_trainer_trains_resumes_evaluates_and_exports(corpus, tmp_path,
                                                      caplog):
    """MASRTrainer(device="cpu") on a 2-layer DS2: 2 epochs of 4 steps, the
    loss falls, a second trainer resumes to step 12; evaluate with each
    decoder (the config's attention_rescoring takes ctc_beam_search with
    a warning) gives a finite (error, loss), the loss the same for every
    decoder; export writes a bundle, byte for byte masr_tpu's of the same
    weights, whose predictor gives the trained model's probs (1e-6)."""
    from masr_tpu.infer.bundle import save_inference_bundle as jax_save
    from masr_tpu_torch.infer.inference_model import InferencePredictor
    from masr_tpu_torch.models.weights import to_flax_variables as to_flax
    from masr_tpu_torch.training.trainer import MASRTrainer
    save = str(tmp_path / "models")
    tr = MASRTrainer(_trainer_config(corpus, str(tmp_path)), device="cpu")
    tr.train(save_model_path=save, augment_conf_path=None)
    losses = _losses(os.path.join(str(tmp_path), "log"))
    assert len(losses) == 8 and np.isfinite(losses).all()
    assert np.mean(losses[-4:]) < losses[0]
    tr2 = MASRTrainer(_trainer_config(corpus, str(tmp_path), 3),
                      device="cpu")
    tr2.train(save_model_path=save, augment_conf_path=None)
    assert tr2.state.step == 12
    best = os.path.join(save, "deepspeech2_streaming_fbank", "best_model")
    logger = logging.getLogger("masr_tpu_torch")
    logger.addHandler(caplog.handler)      # the port's logger propagates not
    try:
        results = {d: tr2.evaluate(resume_model=best, decoder=d)
                   for d in (None, "ctc_greedy", "ctc_beam_search",
                             "ctc_beam_search_device")}
    finally:
        logger.removeHandler(caplog.handler)
    assert "no attention decoder" in caplog.text
    assert results[None] == results["ctc_beam_search"]
    for err, loss in results.values():
        assert 0.0 <= err and np.isfinite(loss)
    assert len({loss for _, loss in results.values()}) == 1
    out = tr2.export(save_model_path=save, resume_model=best)
    assert out.endswith(os.path.join("deepspeech2_streaming_fbank",
                                     "inference_model"))
    ref = str(tmp_path / "jax_bundle")
    with open(os.path.join(out, "inference.json"), encoding="utf-8") as f:
        meta = json.load(f)
    jax_save(ref, "deepspeech2", True, 80, tr2._setup_dataloader(False)[0]
             .vocab_list, meta["mean"], meta["istd"], meta["encoder_conf"],
             meta["decoder_conf"], meta["model_conf"],
             meta["preprocess_conf"], to_flax(tr2.model.state_dict()))
    for name in ("inference.json", "vocabulary.txt", "model.msgpack"):
        with open(os.path.join(out, name), "rb") as a, \
                open(os.path.join(ref, name), "rb") as b:
            assert a.read() == b.read(), name
    ip = InferencePredictor(out, device="cpu")
    rs = np.random.RandomState(2)
    speech = (10.0 + 3.0 * rs.standard_normal((2, 200, 80))).astype(
        np.float32)
    lens = np.asarray([200, 150])
    probs, plens = ip.predict(speech, lens)
    tr2.model.eval()
    with torch.no_grad():
        want, wlens = tr2.model.get_encoder_out(_t(speech), _t(lens))
    assert plens.tolist() == wlens.tolist()
    for b, n in enumerate(plens.tolist()):
        np.testing.assert_allclose(probs[b, :n], want[b, :n].numpy(),
                                   atol=1e-6)


def test_clis_train_export_and_eval_a_gru(corpus, tmp_path, monkeypatch):
    """`masr_tpu_torch.train.main` from the repository root with its
    default --augment_conf_path (configs/augmentation.json: the noise
    item drops, its manifest is absent here; speed, shift, volume,
    SpecAugment and SpecSub augment) trains a GRU DS2 for one epoch; then
    export_model.main writes the bundle and eval.main prints (cer, loss)
    equal to MASRTrainer.evaluate in process."""
    import yaml
    from masr_tpu_torch import eval as eval_cli
    from masr_tpu_torch import export_model, train
    from masr_tpu_torch.training import trainer as trainer_mod
    monkeypatch.chdir(ROOT)
    conf = _trainer_config(corpus, str(tmp_path), 1, use_gru=True)
    conf["decoder"] = "ctc_greedy"
    path = str(tmp_path / "ds2.yml")
    with open(path, "w", encoding="utf-8") as f:
        yaml.safe_dump(conf, f, allow_unicode=True)
    save = str(tmp_path / "models")
    seen, orig = [], trainer_mod.MASRDataset

    def spy(*a, **k):
        seen.append(k.get("augmentation_config"))
        return orig(*a, **k)

    monkeypatch.setattr(trainer_mod, "MASRDataset", spy)
    train.main(["--configs", path, "--use_gpu", "False",
                "--save_model_path", save])
    assert seen[0] == "configs/augmentation.json" and seen[1] == "{}"
    losses = _losses(os.path.join(str(tmp_path), "log"))
    assert len(losses) == 4 and np.isfinite(losses).all()
    ckpt = os.path.join(save, "deepspeech2_streaming_fbank", "last_model")
    export_model.main(["--configs", path, "--use_gpu", "False",
                       "--save_model_path", save, "--resume_model", ckpt])
    assert os.path.exists(os.path.join(save, "deepspeech2_streaming_fbank",
                                       "inference_model", "model.msgpack"))
    cli = eval_cli.main(["--configs", path, "--use_gpu", "False",
                         "--resume_model", ckpt])
    inproc = trainer_mod.MASRTrainer(path, device="cpu").evaluate(
        resume_model=ckpt)
    assert cli == inproc


def test_new_modules_run_without_jax(tmp_path):
    """With jax, flax and masr_tpu blocked from import: every module of the
    package imports; a DS2 takes a train step on waveforms through the
    on-device frontend and the fused Adam, streams a window, and the host
    augmentation pipeline and binary manifests run; nothing of JAX is
    loaded."""
    import subprocess
    import sys
    import textwrap
    code = textwrap.dedent(f"""
        import importlib, json, pkgutil, sys
        class Block:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in ("jax", "jaxlib", "flax",
                                          "masr_tpu"):
                    raise ImportError("blocked: " + name)
        sys.meta_path.insert(0, Block())
        sys.path.insert(0, {ROOT!r})
        import numpy as np, torch
        import masr_tpu_torch
        for m in pkgutil.walk_packages(masr_tpu_torch.__path__,
                                       "masr_tpu_torch."):
            importlib.import_module(m.name)
        from masr_tpu_torch.audio import AudioSegment
        from masr_tpu_torch.data.augmentation import AugmentationPipeline
        from masr_tpu_torch.data.binary import DatasetReader, DatasetWriter
        from masr_tpu_torch.models.registry import build_model
        from masr_tpu_torch.ops.specaug import make_device_frontend
        from masr_tpu_torch.optimizer.schedulers import build_optimizer
        from masr_tpu_torch.training.train_state import TrainState, train_step
        model = build_model("deepspeech2", 80, 10,
                            encoder_conf=dict(num_rnn_layers=2, rnn_size=16))
        opt, sched, _ = build_optimizer(
            model.parameters(), dict(optimizer="AdamW", fused=True))
        state = TrainState(model, opt, sched, frontend=make_device_frontend(
            dict(feature_method="fbank", n_mels=80), dict(F=5, T=5),
            dict(max_t=3, num_t_sub=2)))
        rs = np.random.RandomState(0)
        batch = dict(inputs=torch.from_numpy(
            (rs.standard_normal((2, 16000)) * 2000).astype(np.float32)),
            input_lens=torch.tensor([16000, 12000]),
            labels=torch.tensor([[2, 3, 4], [5, 6, -1]]),
            label_lens=torch.tensor([3, 2]))
        m = train_step(state, batch, 0)
        assert m["finite"] and state.updates == 1
        s = model.init_cache(batch=1)
        probs = model.eval().get_encoder_out_chunk(torch.zeros(1, 67, 80), s)
        assert tuple(probs.shape) == (1, 16, 10)
        pipe = AugmentationPipeline(json.dumps([
            dict(type="speed", prob=1.0), dict(type="specsub", prob=1.0)]),
            seed=0)
        seg = AudioSegment(rs.standard_normal(16000).astype(np.float32),
                           16000)
        pipe.transform_audio(seg)
        pipe.transform_feature(np.ones((50, 80), np.float32))
        w = DatasetWriter("m")
        w.add_data(json.dumps(dict(duration=1.0, text="x")))
        w.close()
        assert DatasetReader("m.data").get_data(0)["text"] == "x"
        assert not any(m.split(".")[0] in ("jax", "flax", "masr_tpu")
                       for m in sys.modules)
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("ok")
