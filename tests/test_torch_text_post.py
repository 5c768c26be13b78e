"""The port's text post-processing against masr_tpu's on the CPU: the
punctuation restorer's three tiers (rules, a bring-your-own plugin, a
transformers token classifier), the inverse text normalizer, use_pun /
is_itn through every MASRPredictor path, and the model zoo (model_tag, the
download, its cache and a malformed bundle over a local zip: nothing is
fetched)."""
import io
import json
import os
import zipfile

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from masr_tpu.infer.itn import SimpleInverseNormalizer as JaxITN
from masr_tpu.infer.punctuation import (PunctuationPredictor as JaxPun,
                                        RulePunctuation as JaxRules)
from masr_tpu_torch.infer.itn import SimpleInverseNormalizer
from masr_tpu_torch.infer.punctuation import (PunctuationPredictor,
                                              RulePunctuation)
# the tiny BERT token classifier (skips when transformers does not import)
from test_punctuation import tiny_bert_dir  # noqa: F401 (fixture)
from test_torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
BUNDLE = os.path.join(REPO, "examples", "tiny_zh_synth", "inference_model")

# the fixed cases of tests/test_punctuation.py and tests/test_itn_zoo.py
PUN_CASES = ["你好吗", "今天天气怎么样呢", "我们走吧", "今天天气很好",
             "我今天去了商店但是没有买东西", "他很努力所以成绩很好", "你好。",
             "", "我吃了饭他也吃了饭大家都吃了饭之后去散步", "hello"]
ITN_CASES = ["百分之五十", "增长了百分之三点五", "三分之二", "占了四分之一左右",
             "下午三点十五分开会", "八点半出发", "十二点整", "圆周率是三点一四",
             "二零二三年五月一日", "一九九八年十二月", "一共五百块", "三十五元",
             "第三十五名", "三百二十五", "一万零二十", "你好"]
NUMERALS = "零一二两三四五六七八九十百千万亿点"
# CJK text, numerals, the ITN units and the punctuation rules' particles
# and conjunctions
ALPHABET = NUMERALS + "年月日号分之半整元块钱第百分吗嘛么呢吧啊呀了的着过" \
    "但是可所以因为然后你好天气我们走去" + "，。 a"


@pytest.mark.parametrize("max_run", [20, 6])
def test_rule_punctuation_fixed_cases(max_run):
    port, ref = RulePunctuation(max_run), JaxRules(max_run)
    for text in PUN_CASES:
        assert port(text) == ref(text), text
    assert RulePunctuation()("你好吗") == "你好吗？"


def test_inverse_normalizer_fixed_cases():
    port, ref = SimpleInverseNormalizer(), JaxITN()
    for text in ITN_CASES:
        assert port.normalize(text) == ref.normalize(text), text
    assert port.normalize("下午三点十五分开会") == "下午3:15开会"


@settings(max_examples=300, deadline=None, database=None)
@given(st.text(alphabet=ALPHABET, max_size=40), st.integers(4, 24))
def test_rules_and_itn_equal_masr_tpus_on_drawn_text(text, max_run):
    """Punctuation rules, ITN, and ITN after punctuation, on drawn strings
    of CJK characters, numerals, units, particles and conjunctions."""
    pun, itn = RulePunctuation(max_run), SimpleInverseNormalizer()
    ref_pun, ref_itn = JaxRules(max_run), JaxITN()
    assert pun(text) == ref_pun(text)
    assert itn.normalize(text) == ref_itn.normalize(text)
    assert itn.normalize(pun(text)) == ref_itn.normalize(ref_pun(text))


def test_plugin_tier(tmp_path):
    (tmp_path / "punctuation.py").write_text(
        "class Predictor:\n"
        "    def __init__(self, model_dir):\n"
        "        self.model_dir = model_dir\n"
        "    def __call__(self, text):\n"
        "        return text + '！'\n", encoding="utf-8")
    port, ref = PunctuationPredictor(str(tmp_path)), JaxPun(str(tmp_path))
    assert port("你好") == ref("你好") == "你好！"
    assert PunctuationPredictor()("你好吗") == JaxPun()("你好吗")


def test_transformers_tier(tiny_bert_dir):
    """A tiny BERT token classifier rigged as tests/test_punctuation.py
    rigs it (吗 → ？, 吧 → 。): the port's tier gives masr_tpu's output."""
    port, ref = PunctuationPredictor(tiny_bert_dir), JaxPun(tiny_bert_dir)
    for text in ("你好吗", "大家都走吧", "天气很好", ""):
        assert port(text) == ref(text), text
    assert port("你好吗").endswith("？")


# --------------------------------------------------------------------------- #
# use_pun / is_itn through the predictor
# --------------------------------------------------------------------------- #
FEAT = 80
NUM_VOCAB = (["<blank>", "<unk>"] + list("零一二三四五六七八九十百千万点分之"
                                          "年月日号块元第半整吗吧呢了但是")
             + ["<eos>"])


@pytest.fixture(scope="module")
def numeral_bundle(tmp_path_factory):
    """A seeded 2-block streaming Conformer over numerals, units and
    particles (CTC head x8: peaked frames), written by the port's
    exporter, so that ITN and punctuation have work to do."""
    from masr_tpu_torch.infer.bundle import save_inference_bundle
    from masr_tpu_torch.models.registry import build_model
    from masr_tpu_torch.models.weights import (seeded_state_dict,
                                               to_flax_variables)
    enc = dict(output_size=32, attention_heads=2, linear_units=64,
               num_blocks=2, cnn_module_kernel=7)
    dec = dict(attention_heads=2, linear_units=32, num_blocks=1,
               r_num_blocks=0)
    model = build_model("conformer", FEAT, len(NUM_VOCAB), streaming=True,
                        encoder_conf=enc, decoder_conf=dec,
                        model_conf=dict(ctc_weight=0.5))
    state = seeded_state_dict(model, 4)
    state["ctc.ctc_lo.weight"] *= 8.0
    out = str(tmp_path_factory.mktemp("numerals"))
    save_inference_bundle(out, "conformer", True, FEAT, NUM_VOCAB,
                          np.full(FEAT, 12.0), np.full(FEAT, 0.3), enc, dec,
                          dict(ctc_weight=0.5),
                          {"feature_method": "fbank", "n_mels": FEAT},
                          to_flax_variables(state))
    return out


@pytest.fixture(scope="module")
def post_predictors(numeral_bundle):
    from masr_tpu.infer.predictor import MASRPredictor as JaxPredictor
    from masr_tpu_torch.infer.predictor import MASRPredictor
    return (MASRPredictor(numeral_bundle, use_pun=True, device="cpu",
                          warmup=False),
            JaxPredictor(numeral_bundle, use_pun=True, warmup=False))


def _waves():
    from test_vad_silero import speech_like
    from masr_tpu_torch.audio.synth_tts import SyntheticTTS
    tts = SyntheticTTS(sample_rate=16000)
    return [tts.render("三十五", spk_id=0), speech_like(1.6, seed=4),
            tts.render("一九九八年", spk_id=1)]


FLAGS = [(False, False), (True, False), (False, True), (True, True)]


@pytest.mark.parametrize("use_pun,is_itn", FLAGS)
def test_predict_and_predict_batch_post_equal_masr_tpus(post_predictors,
                                                        use_pun, is_itn):
    port, ref = post_predictors
    wavs = _waves()
    for wav in wavs:
        got = port.predict(wav, use_pun=use_pun, is_itn=is_itn)
        want = ref.predict(wav, use_pun=use_pun, is_itn=is_itn)
        assert got["text"] == want["text"]
        assert abs(got["score"] - want["score"]) <= 1e-3
    got = port.predict_batch(wavs, use_pun=use_pun, is_itn=is_itn)
    want = ref.predict_batch(wavs, use_pun=use_pun, is_itn=is_itn)
    assert [g["text"] for g in got] == [w["text"] for w in want]
    plain = [r["text"] for r in port.predict_batch(wavs)]
    assert all(plain)       # every utterance decodes to some text
    if use_pun or is_itn:   # each of the two rewrites some text here
        assert [g["text"] for g in got] != plain


@pytest.mark.parametrize("use_pun,is_itn", FLAGS[1:])
def test_predict_stream_post_equal_masr_tpus(post_predictors, use_pun,
                                             is_itn):
    """0.2 s pieces: every partial result and the final one equal
    masr_tpu's; punctuation only in the final one."""
    port, ref = post_predictors
    wav = _waves()[1]
    got, want = [], []
    for pred, out in ((port, got), (ref, want)):
        for i in range(0, len(wav), 3200):
            r = pred.predict_stream(wav[i:i + 3200],
                                    is_end=i + 3200 >= len(wav),
                                    use_pun=use_pun, is_itn=is_itn)
            out.append(r and r["text"])
        pred.reset_stream()
    assert got == want and got[-1]
    if use_pun:
        assert got[-1][-1] in "。？" and not any(
            t and t[-1] in "。？" for t in got[:-1])


@pytest.mark.parametrize("use_pun,is_itn", [(True, True)])
def test_predict_long_post_equal_masr_tpus(post_predictors, use_pun, is_itn):
    port, ref = post_predictors
    sil = np.zeros(12000, np.float32)
    rec = np.concatenate([sil] + [x for w in _waves() for x in (w, sil)])
    got = port.predict_long(rec, use_pun=use_pun, is_itn=is_itn)
    want = ref.predict_long(rec, use_pun=use_pun, is_itn=is_itn)
    assert got["text"] == want["text"] and got["text"].count("，") >= 2
    assert abs(got["score"] - want["score"]) <= 0.01


# --------------------------------------------------------------------------- #
# the model zoo
# --------------------------------------------------------------------------- #
def test_model_tag_resolves_the_in_repo_bundle():
    from masr_tpu_torch.infer import model_zoo
    from masr_tpu_torch.infer.predictor import MASRPredictor
    assert os.path.samefile(model_zoo.get_model_dir("tiny_zh_synth"), BUNDLE)
    by_tag = MASRPredictor(model_tag="tiny_zh_synth", device="cpu",
                           warmup=False)
    by_dir = MASRPredictor(BUNDLE, device="cpu", warmup=False)
    wav = _waves()[0]
    assert by_tag.predict(wav) == by_dir.predict(wav)
    with pytest.raises(ValueError, match="model_dir or model_tag"):
        MASRPredictor(device="cpu")


class _FakeResponse(io.BytesIO):
    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


def _zip(files):
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w") as z:
        for name, data in files.items():
            z.writestr(name, data)
    return buf.getvalue()


@pytest.mark.parametrize("layout", ["wrapped", "flat"])
def test_model_zoo_download_unzip_and_cache(tmp_path, monkeypatch, layout):
    """A registered tag downloads once (a local zip through a monkeypatched
    urlopen), unpacks under CACHE_DIR, drops the zip, and resolves from the
    cache the second time; bundles zipped without the inference_model/
    wrapper resolve too."""
    from masr_tpu_torch.infer import model_zoo
    monkeypatch.setattr(model_zoo, "CACHE_DIR", str(tmp_path))
    prefix = "inference_model/" if layout == "wrapped" else ""
    data = _zip({prefix + "inference.json": json.dumps({"use_model": "c"}),
                 prefix + "vocabulary.txt": "<blank>\t0\n",
                 prefix + "model.msgpack": b"\x80"})
    calls = []

    def fake_urlopen(url):
        calls.append(url)
        return _FakeResponse(data)

    monkeypatch.setattr(model_zoo.urllib.request, "urlopen", fake_urlopen)
    monkeypatch.setitem(model_zoo.MODEL_URLS, "test_tag",
                        "https://example.com/bundle.zip")
    d = model_zoo.get_model_dir("test_tag")
    assert calls == ["https://example.com/bundle.zip"]
    assert os.path.exists(os.path.join(d, "inference.json"))
    want = os.path.join(str(tmp_path), "test_tag",
                        "inference_model" if prefix else "")
    assert os.path.normpath(d) == os.path.normpath(want)
    assert not os.path.exists(os.path.join(str(tmp_path), "test_tag",
                                           "bundle.zip"))
    assert model_zoo.get_model_dir("test_tag") == d and len(calls) == 1


def test_model_zoo_unknown_and_malformed(tmp_path, monkeypatch):
    from masr_tpu_torch.infer import model_zoo
    monkeypatch.setattr(model_zoo, "CACHE_DIR", str(tmp_path))
    with pytest.raises(ValueError, match="unknown model_tag"):
        model_zoo.get_model_dir("no_such_tag")
    monkeypatch.setattr(model_zoo.urllib.request, "urlopen",
                        lambda url: _FakeResponse(_zip({"x.txt": "nope"})))
    monkeypatch.setitem(model_zoo.MODEL_URLS, "bad_tag",
                        "https://example.com/bad.zip")
    with pytest.raises(RuntimeError, match="malformed"):
        model_zoo.get_model_dir("bad_tag")
