"""The port's data preparation and inference CLI against masr_tpu on the
CPU, on a synthesized corpus (masr_tpu_torch/audio/synth_tts.py) written
into tmp_path: create_manifest resamples audio files in place, so each
package works on a fresh copy of the corpus at the same paths, and what
each writes is compared byte for byte.

- create_data (MASRTrainer.create_data of each package, txt and binary
  manifests, with and without a test annotation): the manifests, the noise
  manifest, the vocabulary, mean_istd.json, the binary manifests and the
  resampled audio;
- merge_audio: the merged wavs and `.merge.json`;
- extract_features: the slabs and the `.feature` manifests; the port's
  dataset gives masr_tpu's features for a slab entry, and a tiny
  MASRTrainer run trains on them;
- the three CLIs (`python -m masr_tpu_torch.create_data`,
  `.extract_features`, `.infer_path` in its three modes) with
  `--use_gpu False` in a subprocess where jax, flax and masr_tpu cannot
  be imported.
Mirrors tests/test_data.py's test_is_ustr, test_vocab_layout,
test_normalizer_stats and test_merge_audio_roundtrip."""
import json
import os
import shutil
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from masr_tpu.data import manifest as jman
from masr_tpu.data.dataset import MASRDataset as JaxDataset
from masr_tpu.data.normalizer import FeatureNormalizer as JaxNormalizer
from masr_tpu.data.audio_featurizer import AudioFeaturizer as JaxFeaturizer
from masr_tpu_torch.audio import AudioSegment
from masr_tpu_torch.audio.io import write_wave
from masr_tpu_torch.audio.synth_tts import SyntheticTTS
from masr_tpu_torch.data import manifest as tman
from masr_tpu_torch.data.audio_featurizer import AudioFeaturizer
from masr_tpu_torch.data.dataset import MASRDataset
from masr_tpu_torch.data.normalizer import FeatureNormalizer
from masr_tpu_torch.data.text_featurizer import TextFeaturizer
from test_torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHARS = list("上家音月火少风大你下雪蓝右黑真")
PRE = dict(feature_method="fbank", n_mels=80, sample_rate=16000,
           use_dB_normalization=True, target_dB=-20)


def _write_corpus(work, with_test=True, n=12):
    """Annotation files, audio and noise under `work`: train.txt (n
    utterances with punctuation, upper case and a missing file to skip; two
    at 8 kHz, which create_data rewrites at 16 kHz), extra.json (slices of
    one long file), test.txt when with_test, and a noise directory."""
    tts = SyntheticTTS(sample_rate=16000)
    rs = np.random.RandomState(11)
    for d in ("annotation", "audio", "noise"):
        os.makedirs(os.path.join(work, d), exist_ok=True)
    lines = []
    for i in range(n):
        text = "".join(CHARS[j] for j in rs.randint(0, len(CHARS),
                                                     2 + i % 4))
        wav = tts.render(text, spk_id=i % 3)
        wav = wav + 1e-3 * rs.standard_normal(len(wav)).astype(np.float32)
        path = os.path.join(work, "audio", f"utt_{i}.wav")
        if i in (3, 7):
            write_wave(path, wav[::2], 8000)
        else:
            write_wave(path, wav, 16000)
        decorated = [text, text + "，OK!", "Hi " + text + "。"][i % 3]
        lines.append(f"{path}\t{decorated}")
    lines.append(os.path.join(work, "audio", "missing.wav") + "\t丢失")
    with open(os.path.join(work, "annotation", "train.txt"), "w",
              encoding="utf-8") as f:
        f.write("\n".join(lines) + "\n")
    parts = [tts.render(t, 1) for t in ("上家", "音月火")]
    long_path = os.path.join(work, "audio", "long.wav")
    write_wave(long_path, np.concatenate(parts), 16000)
    cut, end = round(len(parts[0]) / 16000, 3), \
        round(sum(map(len, parts)) / 16000 - 0.001, 3)
    with open(os.path.join(work, "annotation", "extra.json"), "w",
              encoding="utf-8") as f:
        for start, end, text in ((0.0, cut, "上家"), (cut, end, "音月火")):
            f.write(json.dumps({"audio_filepath": long_path, "text": text,
                                "start_time": start, "end_time": end},
                               ensure_ascii=False) + "\n")
    if with_test:
        test_lines = []
        for i in range(3):
            text = "".join(CHARS[j] for j in rs.randint(0, len(CHARS), 3))
            path = os.path.join(work, "audio", f"test_{i}.wav")
            write_wave(path, tts.render(text, spk_id=2), 16000)
            test_lines.append(f"{path}\t{text}")
        with open(os.path.join(work, "annotation", "test.txt"), "w",
                  encoding="utf-8") as f:
            f.write("\n".join(test_lines) + "\n")
    for i in range(2):
        write_wave(os.path.join(work, "noise", f"n{i}.wav"),
                   0.05 * rs.standard_normal(8000).astype(np.float32), 16000)
    with open(os.path.join(work, "noise", "readme.txt"), "w") as f:
        f.write("not audio\n")


def _config(work, manifest_type="txt"):
    d = os.path.join(work, "dataset")
    return {
        "use_model": "conformer", "streaming": True,
        "encoder_conf": dict(output_size=32, attention_heads=2,
                             linear_units=48, num_blocks=2,
                             cnn_module_kernel=7),
        "decoder_conf": dict(attention_heads=2, linear_units=32,
                             num_blocks=1, r_num_blocks=1),
        "model_conf": dict(ctc_weight=0.3, lsm_weight=0.1,
                           reverse_weight=0.3),
        "dataset_conf": dict(
            batch_size=4, num_workers=2, min_duration=0, max_duration=20,
            train_manifest=os.path.join(d, "manifest.train"),
            test_manifest=os.path.join(d, "manifest.test"),
            dataset_vocab=os.path.join(d, "vocabulary.txt"),
            mean_istd_path=os.path.join(d, "mean_istd.json"),
            noise_manifest_path=os.path.join(d, "manifest.noise"),
            manifest_type=manifest_type),
        "preprocess_conf": PRE,
        "optimizer_conf": dict(optimizer="Adam", learning_rate=4e-3,
                               weight_decay=1e-6, scheduler="WarmupLR",
                               scheduler_conf=dict(warmup_steps=2,
                                                   min_lr=1e-5)),
        "train_conf": dict(max_epoch=1, log_interval=1, accum_grad=1,
                           grad_clip=5.0),
        "metrics_type": "cer", "log_dir": os.path.join(work, "log")}


def _snapshot(work):
    """relative path → bytes of every file under work."""
    out = {}
    for root, _, files in os.walk(work):
        for name in files:
            path = os.path.join(root, name)
            rel = os.path.relpath(path, work)
            with open(path, "rb") as f:
                out[rel] = f.read()
    return out


def _fresh(pristine, work):
    shutil.rmtree(work, ignore_errors=True)
    shutil.copytree(pristine, work)


@pytest.fixture
def corpus_pair(tmp_path, monkeypatch):
    """→ (pristine copy, work dir): the corpus written at work, then kept
    at pristine; _fresh restores work before each package runs. masr_tpu's
    trainer keeps its XLA cache under tmp_path."""
    monkeypatch.setenv("MASR_TPU_CACHE_DIR", str(tmp_path / "xla"))
    work, pristine = str(tmp_path / "work"), str(tmp_path / "pristine")
    return pristine, work


def _jax_trainer(conf):
    from masr_tpu.training.trainer import MASRTrainer as JaxTrainer
    return JaxTrainer(conf)


def _port_trainer(conf):
    from masr_tpu_torch.training.trainer import MASRTrainer
    return MASRTrainer(conf, device="cpu")


def test_is_ustr():
    """is_ustr and the text normalization as masr_tpu's (zhconv absent)."""
    assert tman.is_ustr("你好hello 123!@#") == "你好hello 123"
    for text in ("你好hello 123!@#", " Hi 上家，OK! ", "說話 it's ÄB😀",
                 "\t全角ＡＢ１２"):
        assert tman.is_ustr(text) == jman.is_ustr(text)
        assert tman._normalize_text(text) == jman._normalize_text(text)


@pytest.mark.parametrize("manifest_type,with_test", [("txt", True),
                                                     ("binary", False)])
def test_create_data_equals_masr_tpu(corpus_pair, manifest_type, with_test):
    """MASRTrainer.create_data of each package on the same corpus at the
    same paths (count_threshold 2, every training utterance in the
    statistics): every file either writes or rewrites (the manifests, the
    noise manifest, the vocabulary, mean_istd.json, the binary manifests,
    the two 8 kHz wavs rewritten at 16 kHz) byte for byte equal. The
    statistics are equal because the two featurizers give equal bits
    (checked on every training utterance). Without a test annotation the
    shortest 1/20 of the utterances (here 1) form the test manifest."""
    pristine, work = corpus_pair
    _write_corpus(work, with_test)
    shutil.copytree(work, pristine)
    kw = dict(annotation_path=os.path.join(work, "annotation"),
              noise_dir=os.path.join(work, "noise"), num_samples=-1,
              count_threshold=2)
    conf = _config(work, manifest_type)
    _jax_trainer(conf).create_data(**kw)
    want = _snapshot(work)
    _fresh(pristine, work)
    _port_trainer(conf).create_data(**kw)
    got = _snapshot(work)
    made = {"manifest.train", "manifest.test", "manifest.noise",
            "vocabulary.txt", "mean_istd.json"}
    if manifest_type == "binary":
        made |= {f"manifest.{s}.{x}" for s in ("train", "test")
                 for x in ("data", "header")}
    assert {os.path.basename(k) for k in want
            if k.startswith("dataset")} == made
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k] == want[k], k
    for i in (3, 7):
        assert AudioSegment.from_file(os.path.join(
            work, "audio", f"utt_{i}.wav")).sample_rate == 16000
    d = conf["dataset_conf"]
    train = tman.read_manifest(d["train_manifest"])
    test = tman.read_manifest(d["test_manifest"])
    assert len(train) + len(test) == 14 + 3 * with_test
    assert len(test) == (3 if with_test else 1)
    assert [e["duration"] for e in train] == sorted(
        e["duration"] for e in train)
    assert all("ok" in e["text"] or "hi" in e["text"] or
               all("一" <= c <= "鿿" for c in e["text"]) for e in train)
    assert len(tman.read_manifest(d["noise_manifest_path"])) == 2
    feat, jfeat = AudioFeaturizer(**PRE), JaxFeaturizer(**PRE)
    for e in train:
        if "start_time" in e:
            continue
        # featurize normalizes its segment in place: one load each
        np.testing.assert_array_equal(
            feat.featurize(AudioSegment.from_file(e["audio_filepath"])),
            jfeat.featurize(AudioSegment.from_file(e["audio_filepath"])))


def test_vocab_layout(tmp_path):
    """build_vocab's file (the port's, equal to masr_tpu's bytes):
    <blank>, <unk>, characters by count, <eos>; a space is <space>;
    counts under the threshold are dropped."""
    m = str(tmp_path / "m")
    tman._write_jsonl(m, [{"audio_filepath": "a", "duration": 1.0,
                           "text": t} for t in ("你好 吗", "你好", "今天 好")])
    tman.build_vocab(str(tmp_path / "v"), [m], count_threshold=1)
    jman.build_vocab(str(tmp_path / "vj"), [m], count_threshold=1)
    assert (tmp_path / "v").read_bytes() == (tmp_path / "vj").read_bytes()
    tf = TextFeaturizer(str(tmp_path / "v"))
    assert tf.vocab_list[:2] == ["<blank>", "<unk>"]
    assert tf.vocab_list[-1] == "<eos>"
    assert tf.blank_id == 0 and tf.eos_id == tf.vocab_size - 1
    ids = tf.featurize("你好 吗")
    assert len(ids) == 4 and tf.detokenize(ids) == "你好 吗"
    assert tf.featurize("Z")[0] == 1
    tman.build_vocab(str(tmp_path / "v2"), [m], count_threshold=2)
    assert TextFeaturizer(str(tmp_path / "v2")).vocab_list == [
        "<blank>", "<unk>", "好", "你", "<space>", "<eos>"]


def test_normalizer_stats(tmp_path):
    """compute_mean_istd: f64 sums, JSON keys mean / istd / frame_num, the
    same file as masr_tpu's; read back equal; applying it roughly
    whitens."""
    _write_corpus(str(tmp_path), with_test=False, n=4)
    lines = [l.split("\t") for l in (tmp_path / "annotation" / "train.txt")
             .read_text(encoding="utf-8").splitlines()[:4]]
    m = str(tmp_path / "m")
    tman._write_jsonl(m, [{"audio_filepath": p, "duration": 1.0, "text": t}
                          for p, t in lines])
    norm = FeatureNormalizer()
    assert norm.mean is None
    out, jout = str(tmp_path / "mi.json"), str(tmp_path / "mij.json")
    norm.compute_mean_istd(m, AudioFeaturizer(**PRE), out, num_samples=-1)
    JaxNormalizer().compute_mean_istd(m, JaxFeaturizer(**PRE), jout,
                                      num_samples=-1)
    with open(out, "rb") as f, open(jout, "rb") as g:
        assert f.read() == g.read()
    d = json.load(open(out))
    assert sorted(d) == ["frame_num", "istd", "mean"] and d["frame_num"] > 0
    assert norm.mean.shape == norm.istd.shape == (80,)
    loaded = FeatureNormalizer(out)
    np.testing.assert_array_equal(loaded.mean, norm.mean)
    seg = AudioSegment.from_file(lines[0][0])
    assert abs(norm.apply(AudioFeaturizer(**PRE).featurize(seg)).mean()) < 3


def test_merge_audio_roundtrip(corpus_pair):
    """merge_audio packs the utterances into files of about max_duration
    seconds with start / end times; the merged wavs and .merge.json equal
    masr_tpu's bytes; the slices give the original samples back; the
    source annotation goes with remove_original."""
    pristine, work = corpus_pair
    _write_corpus(work, with_test=True)
    shutil.copytree(work, pristine)
    ann, out = os.path.join(work, "annotation"), os.path.join(work, "merged")
    jman.merge_audio(ann, out, max_duration=3, remove_original=True)
    want = _snapshot(work)
    _fresh(pristine, work)
    tman.merge_audio(ann, out, max_duration=3, remove_original=True)
    got = _snapshot(work)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k] == want[k], k
    assert not os.path.exists(os.path.join(ann, "train.txt"))
    assert os.path.exists(os.path.join(ann, "test.txt"))
    entries = tman.read_manifest(os.path.join(ann, "train.merge.json"))
    assert len(entries) == 12 and len(os.listdir(out)) < 12
    src = [l.split("\t")[0] for l in open(os.path.join(
        pristine, "annotation", "train.txt"), encoding="utf-8")
        .read().splitlines()[:12]]
    for e, path in zip(entries, src):
        orig = AudioSegment.from_file(path)
        if orig.sample_rate != 16000:
            continue
        seg = AudioSegment.slice_from_file(e["audio_filepath"],
                                           e["start_time"], e["end_time"])
        n = min(len(seg.samples), len(orig.samples))
        assert n >= len(orig.samples) - 32
        np.testing.assert_allclose(seg.samples[:n], orig.samples[:n],
                                   atol=2e-4)


def test_extract_features_equals_masr_tpu_and_trains(corpus_pair):
    """extract_features of each package (slabs of 4 utterances) after the
    port's create_data: the .npy slabs and the .feature manifests byte for
    byte equal; the port's dataset gives masr_tpu's features for every
    slab entry, refuses return_waveform, and applies the feature
    augmentors in training; a tiny MASRTrainer run (one epoch) trains and
    evaluates on the .feature manifests."""
    pristine, work = corpus_pair
    _write_corpus(work, with_test=True)
    conf = _config(work)
    _port_trainer(conf).create_data(
        annotation_path=os.path.join(work, "annotation"),
        noise_dir=os.path.join(work, "noise"), num_samples=-1,
        count_threshold=1)
    shutil.copytree(work, pristine)
    save = os.path.join(work, "features")
    _jax_trainer(conf).extract_features(save_dir=save, batch_size=4)
    want = _snapshot(work)
    _fresh(pristine, work)
    _port_trainer(conf).extract_features(save_dir=save, batch_size=4)
    got = _snapshot(work)
    assert len([k for k in got if k.endswith(".npy")]) == 5   # 14 + 3
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k] == want[k], k
    d = conf["dataset_conf"]
    train_feat = d["train_manifest"] + ".feature"
    port = MASRDataset(PRE, train_feat, d["dataset_vocab"])
    ref = JaxDataset(PRE, train_feat, d["dataset_vocab"])
    assert len(port) == len(ref) == 14
    for i in range(len(port)):
        (f, ids), (jf, jids) = port[i], ref[i]
        assert f.dtype == np.float32 and f.shape[1] == 80
        np.testing.assert_array_equal(f, jf)
        np.testing.assert_array_equal(ids, jids)
    with pytest.raises(ValueError, match="precomputed"):
        MASRDataset(PRE, train_feat, d["dataset_vocab"],
                    return_waveform=True)[0]
    aug = json.dumps([{"type": "specaug", "prob": 1.0,
                       "params": {"F": 10, "T": 20, "n_freq_masks": 2,
                                  "n_time_masks": 2}}])
    train = MASRDataset(PRE, train_feat, d["dataset_vocab"],
                        augmentation_config=aug, train=True, seed=3)
    assert not np.array_equal(train[5][0], port[5][0])
    conf["dataset_conf"] = dict(d, train_manifest=train_feat,
                                test_manifest=d["test_manifest"] +
                                ".feature")
    tr = _port_trainer(conf)
    tr.train(save_model_path=os.path.join(work, "models"),
             augment_conf_path=None)
    assert tr.state.step == 3
    with open(os.path.join(work, "log", "scalars.jsonl")) as f:
        losses = [json.loads(l)["value"] for l in f
                  if json.loads(l)["tag"] == "Train/Loss"]
    assert len(losses) == 3 and np.isfinite(losses).all()


_BLOCK = """
import runpy, sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "masr_tpu"):
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
sys.path.insert(0, {root!r})
"""


def test_clis_run_without_jax(tmp_path):
    """In one subprocess where jax, flax and masr_tpu cannot be imported,
    with --use_gpu False: `python -m masr_tpu_torch.create_data` (and with
    --is_merge_audio True on a copy of the corpus), `.extract_features`,
    the train CLI for one epoch on the .feature manifests, the export CLI,
    then `.infer_path` in its three modes (short, --is_long_audio,
    --real_time_demo) on the trained bundle and on the in-repo example
    bundle (which transcribes the synthetic voice): each writes what it
    should; infer_path's texts equal the in-process predictor's (predict,
    predict_long, and the last result of predict_stream over 0.5 s
    pieces), the example's short text the rendered sentence; nothing of
    JAX is loaded."""
    import yaml
    work = str(tmp_path / "work")
    _write_corpus(work, with_test=True)
    merge_copy = str(tmp_path / "merge_copy")
    _write_corpus(merge_copy, with_test=True)
    conf = _config(work)
    merge_conf = _config(merge_copy)
    feat_conf = dict(conf, dataset_conf=dict(
        conf["dataset_conf"],
        train_manifest=conf["dataset_conf"]["train_manifest"] + ".feature",
        test_manifest=conf["dataset_conf"]["test_manifest"] + ".feature"))
    paths = {}
    for name, c in (("conf", conf), ("merge", merge_conf),
                    ("feat", feat_conf)):
        paths[name] = str(tmp_path / f"{name}.yml")
        with open(paths[name], "w", encoding="utf-8") as f:
            yaml.safe_dump(c, f, allow_unicode=True)
    wav = os.path.join(work, "audio", "long.wav")
    # the in-repo example bundle recognizes the synthetic voice, so its
    # texts are not empty
    example = os.path.join(ROOT, "examples", "tiny_zh_synth",
                           "inference_model")
    speech = str(tmp_path / "speech.wav")
    voice = SyntheticTTS(sample_rate=16000).render("上家音月火少风", 0)
    write_wave(speech, np.concatenate([np.zeros(8000, np.float32), voice,
                                       np.zeros(8000, np.float32)]) +
               1e-3 * np.random.RandomState(2).standard_normal(
                   len(voice) + 16000).astype(np.float32), 16000)
    models = os.path.join(work, "models")
    bundle = os.path.join(models, "conformer_streaming_fbank",
                          "inference_model")
    code = _BLOCK.format(root=ROOT) + textwrap.dedent(f"""
        import json
        def cli(module, *args):
            sys.argv = [module] + list(args)
            runpy.run_module(module, run_name="__main__", alter_sys=True)
        no_gpu = ("--use_gpu", "False")
        cli("masr_tpu_torch.create_data", "--configs", {paths['merge']!r},
            "--annotation_path", {merge_copy + '/annotation'!r},
            "--noise_dir", {merge_copy + '/noise'!r}, "--count_threshold",
            "1", "--is_merge_audio", "True", "--max_duration", "3",
            "--save_audio_path", {merge_copy + '/merged'!r}, *no_gpu)
        cli("masr_tpu_torch.create_data", "--configs", {paths['conf']!r},
            "--annotation_path", {work + '/annotation'!r},
            "--noise_dir", {work + '/noise'!r}, "--count_threshold", "1",
            *no_gpu)
        cli("masr_tpu_torch.extract_features", "--configs",
            {paths['conf']!r}, "--save_dir", {work + '/features'!r}, *no_gpu)
        cli("masr_tpu_torch.train", "--configs", {paths['feat']!r},
            "--save_model_path", {models!r}, "--augment_conf_path", "none",
            *no_gpu)
        cli("masr_tpu_torch.export_model", "--configs", {paths['feat']!r},
            "--save_model_path", {models!r}, "--resume_model",
            {models + '/conformer_streaming_fbank/last_model'!r}, *no_gpu)
        from masr_tpu_torch import infer_path
        base = ["--wav_path", {wav!r}, "--model_dir", {bundle!r}, *no_gpu]
        out = dict(short=infer_path.main(base),
                   long=infer_path.main(base + ["--is_long_audio", "True"]),
                   demo=infer_path.main(base + ["--real_time_demo", "True"]))
        ex = ["--wav_path", {speech!r}, "--model_dir", {example!r}, *no_gpu]
        out["example"] = dict(
            short=infer_path.main(ex),
            long=infer_path.main(ex + ["--is_long_audio", "True"]),
            demo=infer_path.main(ex + ["--real_time_demo", "True"]))
        assert not any(m.split(".")[0] in ("jax", "jaxlib", "flax",
                                           "masr_tpu") for m in sys.modules)
        print(json.dumps(out, ensure_ascii=False))
    """)
    # one torch thread, as the suite's own processes (test_torch_threads)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    run = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=str(tmp_path), env=env)
    assert run.returncode == 0, run.stderr[-4000:]
    out = json.loads(run.stdout.strip().splitlines()[-1])
    d = os.path.join(work, "dataset")
    for name in ("manifest.train", "manifest.test", "manifest.noise",
                 "vocabulary.txt", "mean_istd.json", "manifest.train.feature",
                 "manifest.test.feature"):
        assert os.path.getsize(os.path.join(d, name)) > 0, name
    assert os.path.exists(os.path.join(merge_copy, "annotation",
                                       "train.merge.json"))
    assert not os.path.exists(os.path.join(merge_copy, "annotation",
                                           "train.txt"))
    assert len(tman.read_manifest(os.path.join(
        merge_copy, "dataset", "manifest.train"))) + len(tman.read_manifest(
            os.path.join(merge_copy, "dataset", "manifest.test"))) == 17
    assert os.path.exists(os.path.join(bundle, "model.msgpack"))
    from masr_tpu_torch.infer.predictor import MASRPredictor
    for res, model_dir, path in ((out, bundle, wav),
                                 (out["example"], example, speech)):
        pred = MASRPredictor(model_dir=model_dir, device="cpu")
        assert res["short"]["text"] == pred.predict(path)["text"]
        assert res["long"]["text"] == pred.predict_long(path)["text"]
        seg = AudioSegment.from_file(path)
        step = int(0.5 * seg.sample_rate)
        last = None
        for i in range(0, len(seg.samples), step):
            r = pred.predict_stream(seg.samples[i:i + step],
                                    is_end=i + step >= len(seg.samples),
                                    sample_rate=seg.sample_rate)
            last = r or last
        assert res["demo"] and res["demo"][-1]["text"] == last["text"]
    assert out["example"]["short"]["text"] == "上家音月火少风"
    assert out["example"]["demo"][-1]["text"]
