"""The port's exporter against masr_tpu's on the CPU: the bundle writer
(masr_tpu_torch/infer/bundle.py save_inference_bundle, f32 / bf16 / int8),
MASRTrainer.export and the export_model and eval CLIs.

Both families at small widths (d=32, 2-3 blocks; the Squeezeformer with
BatchNorm, so its bundle carries batch_stats), weights drawn from a numpy
seed with the CTC head x8 (frames peak as a trained model's do). The same
flax variables go through both packages' writers; each tolerance is stated
where it is used."""
import json
import os

import numpy as np
import pytest
import torch
import jax.numpy as jnp
from flax import serialization
from flax.traverse_util import flatten_dict

from masr_tpu.infer.bundle import (_dequantize_int8 as jax_dequantize,
                                   load_inference_bundle as jax_load,
                                   save_inference_bundle as jax_save)
from masr_tpu_torch.infer import flax_msgpack
from masr_tpu_torch.infer.bundle import (load_inference_bundle,
                                         save_inference_bundle)
from masr_tpu_torch.models.registry import build_model
from masr_tpu_torch.models.weights import (from_flax_variables,
                                           seeded_state_dict,
                                           to_flax_variables)
from test_torch_threads import one_torch_thread  # noqa: F401

FEAT = 80
VOCAB = ["<blank>", "<unk>", "你", "好", "天", "气", "<space>", "<eos>"]
MEAN, ISTD = np.full(FEAT, 15.0), np.full(FEAT, 0.33)
PRE = {"feature_method": "fbank", "n_mels": FEAT}
CONFS = {
    "conformer": (dict(output_size=32, attention_heads=2, linear_units=64,
                       num_blocks=2, cnn_module_kernel=7),
                  dict(attention_heads=2, linear_units=32, num_blocks=1,
                       r_num_blocks=1),
                  dict(ctc_weight=0.5, reverse_weight=0.3)),
    "squeezeformer": (dict(encoder_dim=32, output_size=32, attention_heads=2,
                           num_blocks=3, reduce_idx=1, recover_idx=2,
                           feed_forward_expansion_factor=2,
                           cnn_module_kernel=7),
                      dict(attention_heads=2, linear_units=32, num_blocks=1,
                           r_num_blocks=0),
                      dict(ctc_weight=0.5)),
}
FAMILIES = sorted(CONFS)
QUANTS = [None, "bf16", "int8"]


def _state(family, seed=3):
    enc, dec, mc = CONFS[family]
    model = build_model(family, FEAT, len(VOCAB), streaming=True,
                        encoder_conf=enc, decoder_conf=dec, model_conf=mc)
    state = seeded_state_dict(model, seed)
    state["ctc.ctc_lo.weight"] *= 8.0
    return state


def _save(save, out, family, variables, quant):
    enc, dec, mc = CONFS[family]
    save(out, family, True, FEAT, VOCAB, MEAN, ISTD, enc, dec, mc, PRE,
         variables, quant=quant)
    return out


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    """{(family, quant): (the port's bundle, masr_tpu's bundle)} written
    from the same flax variables."""
    out = {}
    for family in FAMILIES:
        variables = to_flax_variables(_state(family))
        for quant in QUANTS:
            d = tmp_path_factory.mktemp(f"{family}_{quant}")
            out[family, quant] = (
                _save(save_inference_bundle, str(d / "port"), family,
                      variables, quant),
                _save(jax_save, str(d / "jax"), family, variables, quant))
    return out


def _read(path, name):
    with open(os.path.join(path, name), "rb") as f:
        return f.read()


@pytest.mark.parametrize("quant", QUANTS, ids=["f32", "bf16", "int8"])
@pytest.mark.parametrize("family", FAMILIES)
def test_bundle_equals_masr_tpu_export(written, family, quant):
    """The port's bundle == masr_tpu's of the same variables: the three
    files byte for byte, and the trees masr_tpu's load_inference_bundle
    restores from them (after its int8 dequantization) key for key,
    dtype, shape and bytes; the Squeezeformer's holds batch_stats."""
    port, ref = written[family, quant]
    for name in ("inference.json", "vocabulary.txt", "model.msgpack"):
        assert _read(port, name) == _read(ref, name), name
    got, want = jax_load(port)[1], jax_load(ref)[1]
    assert set(got) == ({"params", "batch_stats"} if family ==
                        "squeezeformer" else {"params"})
    got, want = flatten_dict(got), flatten_dict(want)
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert (g.dtype, g.shape) == (w.dtype, w.shape), k
        assert g.tobytes() == w.tobytes(), k
    with open(os.path.join(port, "inference.json"), encoding="utf-8") as f:
        meta = json.load(f)
    assert meta["framework"] == "masr_tpu" and meta["quantization"] == quant


@pytest.mark.parametrize("quant", QUANTS, ids=["f32", "bf16", "int8"])
@pytest.mark.parametrize("family", FAMILIES)
def test_port_reads_its_bundle_back(written, family, quant):
    """The port's reader on its own bundle: the f32 state bit for bit; bf16
    the state rounded to nearest even (torch's conversion) and widened;
    int8 masr_tpu's dequantization of the restored tree, exactly."""
    port, _ = written[family, quant]
    model, meta, vocab = load_inference_bundle(port)
    assert vocab == VOCAB and meta["quantization"] == quant
    state = _state(family)
    if quant == "int8":
        want = from_flax_variables(jax_dequantize(
            serialization.msgpack_restore(bytearray(
                _read(port, "model.msgpack")))))
    else:
        want = {k: v.to(torch.bfloat16).float() if quant == "bf16" else v
                for k, v in state.items()
                if not k.endswith("num_batches_tracked")}
    got = {k: v for k, v in model.state_dict().items()
           if not k.endswith("num_batches_tracked")}
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("family", FAMILIES)
def test_masr_tpu_model_on_port_bundle_gives_port_probs(written, family):
    """masr_tpu's model on the port's f32 bundle vs the port's model on the
    same bundle, get_encoder_out over the valid frames: CTC probs within
    1e-5 (Conformer) and 3e-5 (Squeezeformer: post-norm rows of magnitude
    up to ~4 in another sum order, tests/test_torch_squeezeformer.py)."""
    port_dir, _ = written[family, None]
    jmodel, jv, _, _ = jax_load(port_dir)
    model, _, _ = load_inference_bundle(port_dir)
    rs = np.random.RandomState(6)
    speech = (15.0 + 3.0 * rs.standard_normal((3, 131, FEAT))).astype(
        np.float32)
    lens = np.asarray([131, 100, 55])
    want_p, want_l = jmodel.apply(jv, jnp.asarray(speech), jnp.asarray(lens),
                                  method=type(jmodel).get_encoder_out)
    with torch.no_grad():
        got_p, got_l = model.get_encoder_out(torch.from_numpy(speech),
                                             torch.from_numpy(lens))
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(want_l))
    atol = 1e-5 if family == "conformer" else 3e-5
    for b, n in enumerate(got_l.tolist()):
        np.testing.assert_allclose(got_p[b, :n].numpy(),
                                   np.asarray(want_p)[b, :n], atol=atol,
                                   rtol=0)


@pytest.mark.parametrize("family", FAMILIES)
def test_weight_round_trip_is_exact(family):
    """from_flax_variables(to_flax_variables(state)) == state bit for bit,
    BatchNorm running statistics included (num_batches_tracked is not a
    flax variable)."""
    state = _state(family, seed=11)
    back = from_flax_variables(to_flax_variables(state))
    want = {k: v for k, v in state.items()
            if not k.endswith("num_batches_tracked")}
    assert sorted(back) == sorted(want)
    assert any(k.endswith("running_var") for k in want) == \
        (family == "squeezeformer")
    for k, v in want.items():
        assert torch.equal(back[k], v), k


def test_packb_writes_flax_bytes_with_bfloat16_leaves():
    """packb of a tree with torch bfloat16 leaves (and ints past a byte,
    and ext payloads of fixext sizes) == flax.serialization.to_bytes of
    the same tree with jnp.bfloat16 leaves; rounding to nearest even."""
    rs = np.random.RandomState(0)
    x = (rs.standard_normal((5, 77)) * 100).astype(np.float32)
    x[0, :4] = [1 + 2 ** -8, 1 + 3 * 2 ** -8, -0.0, 3e38]
    tree = {"b": {"kernel": x, "n": np.arange(300, dtype=np.int32)},
            "a": np.zeros((0,), np.float32)}
    port = {"b": {"kernel": torch.from_numpy(x).to(torch.bfloat16),
                  "n": tree["b"]["n"]}, "a": tree["a"]}
    ref = {"b": {"kernel": np.asarray(jnp.asarray(x).astype(jnp.bfloat16)),
                 "n": tree["b"]["n"]}, "a": tree["a"]}
    assert flax_msgpack.packb(port) == serialization.to_bytes(ref)
    assert flax_msgpack.packb(tree) == serialization.to_bytes(tree)


# --------------------------------------------------------------------------- #
# MASRTrainer.export and the CLIs
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    from test_torch_training import _corpus
    return _corpus(str(tmp_path_factory.mktemp("export_corpus")), n_train=4,
                   n_test=4)


def _config(corpus, root):
    from test_torch_training import _trainer_config
    return _trainer_config(corpus, root, 1)


@pytest.fixture(scope="module")
def checkpoint(corpus, tmp_path_factory):
    """A checkpoint of the tiny config's freshly set-up model (the
    verify recipe's widths) → (config, checkpoint dir, its state)."""
    from masr_tpu_torch.training import checkpoints as ckpt
    from masr_tpu_torch.training.trainer import MASRTrainer
    root = str(tmp_path_factory.mktemp("export_run"))
    conf = _config(corpus, root)
    tr = MASRTrainer(conf, device="cpu")
    ds, _, _ = tr._setup_dataloader(False)
    tr._setup_model(ds.feature_dim, ds.vocab_size)
    with torch.no_grad():
        for p in tr.model.parameters():
            p.add_(0.01 * torch.randn(p.shape,
                                      generator=torch.Generator()
                                      .manual_seed(1)))
    path = ckpt.save_checkpoint(os.path.join(root, "ckpts"), 1,
                                tr.state.state_dict())
    return conf, path, {k: v.clone() for k, v in tr.model.state_dict().items()}


def test_trainer_export_writes_masr_tpu_bundle(checkpoint, corpus, tmp_path):
    """MASRTrainer.export → {save}/conformer_streaming_fbank/
    inference_model, with the files masr_tpu's save_inference_bundle
    writes for the checkpoint's variables, the config's confs, the
    corpus's vocabulary and CMVN; half=True writes bf16."""
    from masr_tpu.data.normalizer import FeatureNormalizer
    from masr_tpu.data.text_featurizer import TextFeaturizer
    from masr_tpu_torch.training.trainer import MASRTrainer
    conf, path, state = checkpoint
    out = MASRTrainer(conf, device="cpu").export(
        save_model_path=str(tmp_path / "models"), resume_model=path)
    assert out == os.path.join(str(tmp_path / "models"),
                               "conformer_streaming_fbank", "inference_model")
    norm = FeatureNormalizer(corpus["cmvn"])
    ref = str(tmp_path / "ref")
    jax_save(ref, "conformer", True, FEAT,
             TextFeaturizer(corpus["vocab"]).vocab_list, norm.mean,
             norm.istd, conf["encoder_conf"], conf["decoder_conf"],
             conf["model_conf"], conf["preprocess_conf"],
             to_flax_variables(state))
    for name in ("inference.json", "vocabulary.txt", "model.msgpack"):
        assert _read(out, name) == _read(ref, name), name
    half = MASRTrainer(conf, device="cpu").export(
        save_model_path=str(tmp_path / "half"), resume_model=path, half=True)
    assert jax_load(half)[2]["quantization"] == "bf16"


def test_export_and_eval_clis_on_the_cpu(checkpoint, corpus, tmp_path):
    """`python -m masr_tpu_torch.export_model` and `... .eval` with
    --use_gpu False on a YAML config: the int8 bundle masr_tpu loads, and
    the eval CLI's (error rate, loss) == MASRTrainer.evaluate in process;
    --save_quant's aliases."""
    import yaml
    from masr_tpu_torch import eval as eval_cli
    from masr_tpu_torch import export_model
    from masr_tpu_torch.training.trainer import MASRTrainer
    conf, path, _ = checkpoint
    cfg = tmp_path / "tiny.yml"
    cfg.write_text(yaml.safe_dump(conf, allow_unicode=True), encoding="utf-8")
    out = export_model.main(["--configs", str(cfg), "--use_gpu", "False",
                             "--resume_model", path, "--save_model_path",
                             str(tmp_path / "models"), "--save_quant",
                             "int8"])
    assert jax_load(out)[2]["quantization"] == "int8"
    got = eval_cli.main(["--configs", str(cfg), "--use_gpu", "False",
                         "--resume_model", path])
    want = MASRTrainer(conf, device="cpu").evaluate(resume_model=path)
    assert got == want and np.isfinite(got[1])
    assert [export_model.parse_quant(v) for v in
            ("True", "1", "bf16", "INT8", "False", "", None)] == \
        ["bf16", "bf16", "bf16", "int8", None, None, None]


def test_clis_refuse_a_missing_card(checkpoint, tmp_path, monkeypatch):
    """--use_gpu True (the default) without CUDA raises, as the predictor
    and the trainer do: no silent CPU."""
    import yaml
    from masr_tpu_torch import eval as eval_cli
    from masr_tpu_torch import export_model
    conf, path, _ = checkpoint
    cfg = tmp_path / "tiny.yml"
    cfg.write_text(yaml.safe_dump(conf), encoding="utf-8")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cli in (export_model, eval_cli):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli.main(["--configs", str(cfg), "--resume_model", path])
