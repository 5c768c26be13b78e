"""The port's offline predictor (masr_tpu_torch.infer.predictor) on the
in-repo trained bundle against masr_tpu's MASRPredictor, plus the port's
import and device rules: no JAX at import or run time, no silent CPU."""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
from test_torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
BUNDLE = os.path.join(REPO, "examples", "tiny_zh_synth", "inference_model")
# "你好世界" and the first three held-out sentences of the bundle's corpus
# (tools/head_to_head.py make_corpus(240, 24), as
# tests/test_example_bundle.py uses them), with their speaker ids
SENTENCES = [("你好世界", 0), ("上家音月火少", 0), ("风大你火下雪", 1),
             ("蓝右黑真", 0)]


def _render(text, spk):
    from masr_tpu_torch.audio.synth_tts import SyntheticTTS
    return SyntheticTTS(sample_rate=16000).render(text, spk_id=spk)


@pytest.fixture(scope="module")
def predictors():
    from masr_tpu.infer.predictor import MASRPredictor as JaxPredictor
    from masr_tpu_torch.infer.predictor import MASRPredictor
    return (MASRPredictor(model_dir=BUNDLE, device="cpu"),
            JaxPredictor(model_dir=BUNDLE, warmup=False))


def test_predict_matches_masr_tpu(predictors):
    """Same text, scores within 1e-3, utterance by utterance."""
    port, ref = predictors
    for text, spk in SENTENCES:
        wav = _render(text, spk)
        got, want = port.predict(wav), ref.predict(wav)
        assert got["text"] == want["text"], text
        assert abs(got["score"] - want["score"]) <= 1e-3, text


def test_predict_batch_matches_masr_tpu(predictors):
    port, ref = predictors
    wavs = [_render(text, spk) for text, spk in SENTENCES]
    got, want = port.predict_batch(wavs), ref.predict_batch(wavs)
    assert [g["text"] for g in got] == [w["text"] for w in want]
    for g, w in zip(got, want):
        assert abs(g["score"] - w["score"]) <= 1e-3
    # the bundle transcribes its held-out sentences (>= 2/3, as masr_tpu's
    # own example-bundle test requires)
    hits = sum(g["text"] == text for g, (text, _) in zip(got[1:],
                                                         SENTENCES[1:]))
    assert hits >= 2


def test_greedy_decoder_equals_masr_tpu():
    """Collapse repeats, drop blanks, map <space>: same (score, text)."""
    from masr_tpu.decoders.greedy import greedy_decoder as jax_greedy
    from masr_tpu_torch.decoders.greedy import greedy_decoder
    rs = np.random.RandomState(0)
    vocab = ["<blank>", "<unk>", "<space>", "a", "b", "c", "<eos>"]
    probs = rs.dirichlet(np.full(len(vocab), 0.3), size=60)
    probs[10:20] = probs[10]                          # a run of repeats
    assert greedy_decoder(probs, vocab) == jax_greedy(probs, vocab)


def test_port_runs_without_jax():
    """With jax, flax and masr_tpu blocked from import, the predictor and
    chip_smoke.py import, and the predictor transcribes on the CPU."""
    code = textwrap.dedent(f"""
        import sys
        class Block:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in ("jax", "jaxlib", "flax",
                                          "masr_tpu"):
                    raise ImportError("blocked: " + name)
        sys.meta_path.insert(0, Block())
        sys.path.insert(0, {REPO!r})
        from masr_tpu_torch.infer.predictor import MASRPredictor
        from masr_tpu_torch.audio.synth_tts import SyntheticTTS
        import masr_tpu_torch.ops.cuda.build
        import chip_smoke
        p = MASRPredictor(model_dir={BUNDLE!r}, device="cpu", warmup=False)
        print(p.predict(SyntheticTTS().render("你好世界"))["text"])
        assert not any(m.split(".")[0] in ("jax", "flax", "masr_tpu")
                       for m in sys.modules)
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=REPO)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip()


def test_cuda_device_without_cuda_raises(monkeypatch):
    """device="cuda" with no CUDA raises instead of running on the CPU."""
    from masr_tpu_torch.infer.predictor import MASRPredictor
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        MASRPredictor(model_dir=BUNDLE, device="cuda")
