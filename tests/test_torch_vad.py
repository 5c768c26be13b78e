"""The port's VAD and long-audio recognition against masr_tpu's on the CPU:
its copy of silero_vad.onnx, its copy of the numpy ONNX executor, the
silero model's window probabilities, get_speech_timestamps, stream_vad (and
the energy heuristic without the model), and MASRPredictor.predict_long on
the in-repo example bundle."""
import hashlib
import os

import numpy as np
import pytest

import masr_tpu.infer.onnx_runtime as jort
import masr_tpu.infer.vad as jvad
import masr_tpu_torch.infer.onnx_runtime as tort
import masr_tpu_torch.infer.vad as tvad
from test_vad_silero import SR, speech_like
from test_torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
BUNDLE = os.path.join(REPO, "examples", "tiny_zh_synth", "inference_model")


def _two_segments():
    """tests/test_vad_silero.py's recording: silence | speech | silence |
    speech | silence."""
    sil = np.zeros(SR, np.float32)
    return np.concatenate([sil, speech_like(1.2, seed=1), sil,
                           speech_like(0.8, seed=2), sil])


def test_model_file_is_the_port_copy_of_masr_tpus():
    """Same bytes (sha256), and the port reads its own file."""
    def digest(path):
        with open(path, "rb") as f:
            return hashlib.sha256(f.read()).hexdigest()
    assert os.path.dirname(tvad._SILERO_PATH) == os.path.dirname(
        tort.__file__)
    assert tvad._SILERO_PATH != jvad._SILERO_PATH
    assert digest(tvad._SILERO_PATH) == digest(jvad._SILERO_PATH)


class _A:
    def __init__(self, ints=None, i=None):
        self.ints = ints or []
        self.i = i


@pytest.mark.parametrize("op", ["conv", "conv_depthwise", "lstm", "sigmoid",
                                "slice", "pad"])
def test_executor_ops_equal_masr_tpus(op):
    """Each numpy op of the port's executor == masr_tpu's on random inputs,
    bit for bit."""
    rs = np.random.RandomState(len(op))
    if op.startswith("conv"):
        groups = 8 if op == "conv_depthwise" else 1
        x = rs.standard_normal((2, 8, 45)).astype(np.float32)
        w = rs.standard_normal((8, 8 // groups, 5)).astype(np.float32)
        b = rs.standard_normal(8).astype(np.float32)
        attrs = {"strides": _A(ints=[2]), "pads": _A(ints=[2, 2]),
                 "group": _A(i=groups)}
        got, want = tort._conv(x, w, b, attrs), jort._conv(x, w, b, attrs)
    elif op == "lstm":
        T, B, I, H = 5, 2, 6, 8
        args = (rs.standard_normal((T, B, I)),
                rs.standard_normal((1, 4 * H, I)),
                rs.standard_normal((1, 4 * H, H)),
                rs.standard_normal((1, 8 * H)), rs.standard_normal((1, B, H)),
                rs.standard_normal((1, B, H)))
        args = tuple(a.astype(np.float32) for a in args)
        got, want = tort._lstm(*args, H), jort._lstm(*args, H)
    elif op == "sigmoid":
        x = (10 * rs.standard_normal(100)).astype(np.float32)
        got, want = tort._sigmoid(x), jort._sigmoid(x)
    elif op == "slice":
        x = rs.standard_normal((4, 9, 7)).astype(np.float32)
        args = (np.asarray([1, -6]), np.asarray([4, 2 ** 63 - 1]),
                np.asarray([0, 1]), np.asarray([1, 2]))
        got, want = tort._slice_op(x, *args), jort._slice_op(x, *args)
    else:
        x = rs.standard_normal((2, 3, 10)).astype(np.float32)
        pads = np.asarray([0, 0, 3, 0, 0, 2])
        got = tort._pad_op(x, pads, b"reflect", None)
        want = jort._pad_op(x, pads, b"reflect", None)
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        np.testing.assert_array_equal(g, w)


def test_executor_runs_the_graph_as_masr_tpus():
    """The whole silero graph, parsed from each package's file and run on
    the same window and state: the same initializers and the same outputs,
    bit for bit."""
    port, ref = tort.OnnxModel(tvad._SILERO_PATH), \
        jort.OnnxModel(jvad._SILERO_PATH)
    assert port.input_names == ref.input_names
    assert sorted(port.graph.inits) == sorted(ref.graph.inits)
    for k, v in ref.graph.inits.items():
        np.testing.assert_array_equal(port.graph.inits[k], v)
    rs = np.random.RandomState(2)
    feeds = {"input": speech_like(0.032 * 2, seed=3)[None, :512],
             "sr": np.asarray(16000, np.int64),
             "h": (0.1 * rs.standard_normal((2, 1, 64))).astype(np.float32),
             "c": (0.1 * rs.standard_normal((2, 1, 64))).astype(np.float32)}
    got, want = port.run(dict(feeds)), ref.run(dict(feeds))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_window_probs_match_masr_tpus():
    """Per-window probs with carried state, and the batched run_sequence,
    within 1e-6 of masr_tpu's; the state after the last window too."""
    wav = _two_segments()
    wins = wav[: (len(wav) // 512) * 512].reshape(-1, 512)
    port, ref = tvad.SileroVAD(), jvad.SileroVAD()
    for _ in range(2):          # the per-window loop, then run_sequence
        got = np.asarray([port(w) for w in wins[:40]])
        want = np.asarray([ref(w) for w in wins[:40]])
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
        port.reset_states()
        ref.reset_states()
    np.testing.assert_allclose(port.run_sequence(wins), ref.run_sequence(wins),
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(port._h, ref._h, atol=1e-6, rtol=0)
    np.testing.assert_allclose(port._c, ref._c, atol=1e-6, rtol=0)


@pytest.mark.parametrize("use_model", [True, False],
                         ids=["silero", "heuristic"])
def test_timestamps_and_stream_events_equal_masr_tpus(use_model):
    """get_speech_timestamps (vectorised path, and the per-window loop) and
    stream_vad in 100 ms chunks: exactly masr_tpu's, with the silero model
    and with the energy heuristic that stands in for a missing model."""
    wav = _two_segments()
    port = tvad.VADPredictor(use_model=use_model)
    ref = jvad.VADPredictor(use_model=use_model)
    assert (port.silero is not None) == use_model
    ts = port.get_speech_timestamps(wav, SR)
    assert ts == ref.get_speech_timestamps(wav, SR)
    if use_model:
        assert len(ts) == 2
        port.silero._fast = ref.silero._fast = None
        assert port.get_speech_timestamps(wav, SR) == \
            ref.get_speech_timestamps(wav, SR) == ts
    port.reset_states()
    ref.reset_states()
    got, want = [], []
    for i in range(0, len(wav), 1600):
        got += port.stream_vad(wav[i:i + 1600], SR)
        want += ref.stream_vad(wav[i:i + 1600], SR)
    assert got == want and len(got) >= 2


def long_recording(n_items=24, seed=3):
    """Silences of 0.5-1.2 s between the example corpus's sentences (the
    synthetic voice, 4 speakers) and speech-like stretches, in turn."""
    from masr_tpu_torch.audio.synth_tts import SyntheticTTS
    tts = SyntheticTTS(sample_rate=SR)
    rs = np.random.RandomState(seed)
    chars = "上家音月火少风大你火下雪蓝右黑真好天气"
    parts = []
    for k in range(n_items):
        parts.append(np.zeros(int(rs.uniform(0.5, 1.2) * SR), np.float32))
        if k % 3 != 2:
            text = "".join(chars[i] for i in rs.randint(0, len(chars), 4))
            parts.append(tts.render(text, spk_id=k % 4))
        else:
            parts.append(speech_like(rs.uniform(0.8, 1.5), seed=k))
    parts.append(np.zeros(SR // 2, np.float32))
    return np.concatenate(parts).astype(np.float32)


@pytest.fixture(scope="module")
def long_predictors():
    from masr_tpu.infer.predictor import MASRPredictor as JaxPredictor
    from masr_tpu_torch.infer.predictor import MASRPredictor
    return (MASRPredictor(model_dir=BUNDLE, device="cpu", warmup=False),
            JaxPredictor(model_dir=BUNDLE, warmup=False))


def test_predict_long_matches_masr_tpus(long_predictors):
    """predict_long of a ~45 s recording on the example bundle: the port's
    VAD gives masr_tpu's segments (more than one group of 16), the joined
    text is masr_tpu's and the score (the segments' mean, rounded to 2
    places) within one rounding step (0.01) of it; the port's segments
    were recognized in batches (predict_batch), not one by one."""
    port, ref = long_predictors
    rec = long_recording()
    calls, orig = [], port.predict_batch

    def counted(audio_list, **kw):
        calls.append(len(audio_list))
        return orig(audio_list, **kw)

    port.predict_batch = counted
    got, want = port.predict_long(rec), ref.predict_long(rec)
    segs = port._vad.get_speech_timestamps(rec, SR)
    assert segs == ref._vad.get_speech_timestamps(rec, SR)
    assert len(segs) > 16 and calls == [16, len(segs) - 16]
    assert got["text"] == want["text"] and got["text"].count("，") >= 10
    assert abs(got["score"] - want["score"]) <= 0.01
