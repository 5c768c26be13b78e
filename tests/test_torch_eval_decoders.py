"""MASRTrainer's eval with each decoder (ctc_greedy, ctc_beam_search,
attention_rescoring, ctc_beam_search_device, named by the config's
`decoder` key) on a tiny config, against masr_tpu's on the same weights:
the same hypothesis for every utterance, the same error rate, the loss
within 1e-4 relative. The eval forward runs the training-layer and CTC
kernels' plain twins on the CPU; rescoring reuses the eval encode's rows.
"""
import json
import os

import numpy as np
import pytest

from test_torch_rescoring import DEC, FAMILIES, FEAT, VOCAB, _perturb
from test_torch_threads import one_torch_thread  # noqa: F401

EVAL_CHARS = "你好天气真完我家业世界"


@pytest.fixture(scope="module")
def eval_corpus(tmp_path_factory):
    from masr_tpu_torch.audio.io import write_wave
    from masr_tpu_torch.audio.synth_tts import SyntheticTTS
    root = str(tmp_path_factory.mktemp("eval_corpus"))
    tts = SyntheticTTS(sample_rate=16000)
    rs = np.random.RandomState(11)
    rows = []
    for i in range(6):
        text = "".join(rs.choice(list(EVAL_CHARS), 2 + i % 4))
        path = os.path.join(root, f"u{i}.wav")
        wav = tts.render(text, spk_id=i % 3)
        write_wave(path, wav, 16000)
        rows.append({"audio_filepath": path, "duration": len(wav) / 16000,
                     "text": text})
    rows.sort(key=lambda r: r["duration"])
    paths = {"vocab": os.path.join(root, "vocabulary.txt"),
             "cmvn": os.path.join(root, "mean_istd.json"),
             "test": os.path.join(root, "manifest.test")}
    with open(paths["test"], "w", encoding="utf-8") as f:
        f.writelines(json.dumps(r, ensure_ascii=False) + "\n" for r in rows)
    with open(paths["vocab"], "w", encoding="utf-8") as f:
        f.writelines(t + "\n" for t in VOCAB)
    with open(paths["cmvn"], "w", encoding="utf-8") as f:
        json.dump({"mean": [10.0] * FEAT, "istd": [0.3] * FEAT}, f)
    return paths


def _eval_config(corpus, decoder):
    return {
        "encoder_conf": FAMILIES["conformer"],
        "decoder_conf": DEC,
        "model_conf": dict(ctc_weight=0.3, lsm_weight=0.1,
                           reverse_weight=0.3),
        "dataset_conf": dict(batch_size=3, num_workers=1, min_duration=0,
                             max_duration=20, train_manifest=corpus["test"],
                             test_manifest=corpus["test"],
                             dataset_vocab=corpus["vocab"],
                             mean_istd_path=corpus["cmvn"]),
        "preprocess_conf": dict(feature_method="fbank", n_mels=FEAT,
                                sample_rate=16000,
                                use_dB_normalization=True, target_dB=-20),
        "optimizer_conf": dict(optimizer="Adam", learning_rate=1e-3,
                               weight_decay=1e-6, scheduler="WarmupLR",
                               scheduler_conf=dict(warmup_steps=4)),
        "train_conf": dict(max_epoch=1),
        "ctc_beam_search_decoder_conf": dict(alpha=2.2, beta=4.3,
                                             beam_size=20, cutoff_prob=0.99,
                                             cutoff_top_n=40,
                                             rescoring_nbest=10),
        "use_model": "conformer", "streaming": False, "decoder": decoder,
        "metrics_type": "cer"}


@pytest.fixture(scope="module")
def eval_trainers(eval_corpus):
    """(port trainer, masr_tpu trainer) holding the same weights: masr_tpu's
    init, perturbed, the CTC head x8, carried into the port. A
    non-streaming model: its eval loss draws no dynamic chunk (the two
    packages draw theirs from different generators)."""
    from masr_tpu.training.trainer import MASRTrainer as Ref
    from masr_tpu_torch.models.weights import from_flax_variables
    from masr_tpu_torch.training.trainer import MASRTrainer
    conf = _eval_config(eval_corpus, "ctc_greedy")
    ref = Ref(conf)
    ds, _, _ = ref._setup_dataloader(False)
    ref._setup_model(ds.feature_dim, ds.vocab_size)
    v = _perturb(ref.variables, 4, 0.05)
    v["params"]["ctc"]["ctc_lo"] = {
        k: t * 8.0 for k, t in v["params"]["ctc"]["ctc_lo"].items()}
    ref.variables = v
    port = MASRTrainer(conf, device="cpu")
    pds, _, _ = port._setup_dataloader(False)
    port._setup_model(pds.feature_dim, pds.vocab_size)
    missing, unexpected = port.model.load_state_dict(
        from_flax_variables(v), strict=False)
    assert not unexpected and all(k.endswith("num_batches_tracked")
                                  for k in missing)
    return port, ref


@pytest.mark.parametrize("decoder", ["ctc_greedy", "ctc_beam_search",
                                     "attention_rescoring",
                                     "ctc_beam_search_device"])
def test_trainer_eval_equals_masr_tpu(eval_trainers, decoder, monkeypatch):
    """The eval pass with each decoder (named by the config's `decoder`
    key): masr_tpu's hypothesis for every utterance, its error rate, and
    its loss within 1e-4 relative."""
    import masr_tpu.training.trainer as jtr
    import masr_tpu_torch.training.trainer as ptr
    port, ref = eval_trainers
    for t in (port, ref):
        t.configs["decoder"] = decoder
    hyps = {}
    for mod, name in ((ptr, "port"), (jtr, "ref")):
        seen = hyps.setdefault(name, [])
        monkeypatch.setattr(mod, "cer", lambda r, h, seen=seen, c=mod.cer:
                            (seen.append(h), c(r, h))[1])
    pds, _, ploader = port._setup_dataloader(False)
    jds, _, jloader = ref._setup_dataloader(False)
    got = port._evaluate_loader(ploader, pds)
    want = ref._evaluate_loader(jloader, jds)
    assert hyps["port"] == hyps["ref"] and len(hyps["port"]) == 6
    assert got[0] == want[0]
    np.testing.assert_allclose(got[1], want[1], rtol=1e-4)
    if decoder in ("ctc_beam_search", "attention_rescoring"):
        assert port._eval_beam_decoder.engine == "native"
