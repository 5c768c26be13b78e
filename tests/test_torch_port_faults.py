"""Three places where the port answered differently from masr_tpu, held
against masr_tpu on the CPU:

- MASRTrainer.train's augment_conf_path defaults to masr_tpu's
  "configs/augmentation.json", and the default reads that file;
- MASRTrainer takes masr_tpu's (configs, use_gpu, overwrites) and
  MASRPredictor masr_tpu's itn keyword, each in masr_tpu's position;
- train_conf.init_type "torch_default": for all four families, every
  parameter starts from the family and bounds that masr_tpu's
  torch_default_reinit gives it (ones, zeros, or a random draw whose
  spread and largest magnitude match, parameter by parameter).
"""
import inspect
import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from masr_tpu.models.initializers import torch_default_reinit
from masr_tpu.models.registry import build_model as build_flax_model
from masr_tpu_torch.models.registry import build_model
from masr_tpu_torch.models.weights import (from_flax_variables,
                                           torch_default_like_init)
from test_torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
EXAMPLE = os.path.join(REPO, "examples", "tiny_zh_synth", "inference_model")


def _trainer_config(root):
    return {"dataset_conf": dict(batch_size=2, num_workers=1,
                                 train_manifest=os.path.join(root, "m.txt"),
                                 test_manifest=os.path.join(root, "m.txt"),
                                 dataset_vocab=os.path.join(root, "v.txt"),
                                 mean_istd_path=os.path.join(root, "c.json")),
            "preprocess_conf": dict(feature_method="fbank", n_mels=80),
            "optimizer_conf": dict(optimizer="Adam", learning_rate=1e-3),
            "train_conf": dict(max_epoch=1),
            "use_model": "conformer", "streaming": True}


class _Stop(Exception):
    pass


def test_train_defaults_to_the_augmentation_file(tmp_path, monkeypatch):
    """train's augment_conf_path default is masr_tpu's; from a directory
    that holds configs/augmentation.json, train() with no argument hands
    that file to the training set, and augment_conf_path=None hands it
    none ("{}")."""
    from masr_tpu.training.trainer import MASRTrainer as JaxTrainer
    from masr_tpu_torch.training import trainer as trainer_module
    want = inspect.signature(JaxTrainer.train).parameters[
        "augment_conf_path"].default
    got = inspect.signature(trainer_module.MASRTrainer.train).parameters[
        "augment_conf_path"].default
    assert got == want == "configs/augmentation.json"
    os.makedirs(tmp_path / "configs")
    with open(tmp_path / "configs" / "augmentation.json", "w") as f:
        json.dump([{"type": "speed", "prob": 0.0}], f)
    seen = []

    def dataset(*args, augmentation_config=None, train=False, **kw):
        seen.append((augmentation_config, train))
        raise _Stop

    monkeypatch.setattr(trainer_module, "MASRDataset", dataset)
    monkeypatch.chdir(tmp_path)
    for kw in ({}, {"augment_conf_path": None}):
        tr = trainer_module.MASRTrainer(_trainer_config(str(tmp_path)),
                                        device="cpu")
        with pytest.raises(_Stop):
            tr.train(save_model_path=str(tmp_path / "models"), **kw)
    assert seen == [("configs/augmentation.json", True), ("{}", True)]


def _positional(fn):
    return [p.name for p in inspect.signature(fn).parameters.values()
            if p.name != "self"]


def test_constructors_take_masr_tpu_keywords(tmp_path):
    """MASRTrainer(configs, use_gpu, overwrites) as the root train.py calls
    masr_tpu's (use_gpu=False: the CPU; True without a card raises, no
    silent CPU; device= still works), and MASRPredictor(..., itn=False):
    masr_tpu's parameters come first, in its order."""
    from masr_tpu.infer.predictor import MASRPredictor as JaxPredictor
    from masr_tpu.training.trainer import MASRTrainer as JaxTrainer
    from masr_tpu_torch.infer.predictor import MASRPredictor
    from masr_tpu_torch.training.trainer import MASRTrainer
    for port, ref in ((MASRTrainer.__init__, JaxTrainer.__init__),
                      (MASRPredictor.__init__, JaxPredictor.__init__)):
        want = _positional(ref)
        assert _positional(port)[:len(want)] == want
    conf = _trainer_config(str(tmp_path))
    tr = MASRTrainer(configs=conf, use_gpu=False,
                     overwrites="train_conf.max_epoch=3")
    assert tr.device.type == "cpu" and tr.configs.train_conf.max_epoch == 3
    assert MASRTrainer(conf, False).device.type == "cpu"
    assert MASRTrainer(conf, device="cpu").device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            MASRTrainer(conf, use_gpu=True)
    pred = MASRPredictor(model_dir=EXAMPLE, itn=False, warmup=False,
                         device="cpu")
    assert pred.predictor.device.type == "cpu"


# --------------------------------------------------------------------------- #
# init_type: torch_default
# --------------------------------------------------------------------------- #
FAMILIES = {
    "conformer": dict(output_size=64, attention_heads=2, linear_units=128,
                      num_blocks=1, cnn_module_kernel=7),
    "squeezeformer": dict(encoder_dim=64, output_size=64, attention_heads=2,
                          num_blocks=3, reduce_idx=1, recover_idx=2,
                          feed_forward_expansion_factor=2,
                          cnn_module_kernel=7),
    "efficient_conformer": dict(output_size=64, attention_heads=2,
                                linear_units=96, num_blocks=2,
                                cnn_module_kernel=7,
                                efficient_conf=dict(
                                    stride_layer_idx=[1], stride=[2],
                                    group_layer_idx=[0, 1], group_size=3)),
    "deepspeech2": dict(num_rnn_layers=1, rnn_size=64),
}
DEC = dict(attention_heads=2, linear_units=64, num_blocks=1, r_num_blocks=1)


def _kind(a):
    a = np.asarray(a, np.float64)
    if np.all(a == 1.0):
        return "ones"
    if np.all(a == 0.0):
        return "zeros"
    return "random"


def _flax_torch_default(family):
    """masr_tpu's model of `family` initialised and redrawn by
    torch_default_reinit, in the port's layout."""
    dec = {} if family == "deepspeech2" else DEC
    # reverse_weight > 0: masr_tpu's init reaches its right decoder
    conf = {} if family == "deepspeech2" else dict(ctc_weight=0.3,
                                                   reverse_weight=0.3)
    fm = build_flax_model(family, 80, 50, streaming=family != "deepspeech2",
                          encoder_conf=FAMILIES[family], decoder_conf=dec,
                          model_conf=conf)
    key = jax.random.PRNGKey(0)
    v = jax.jit(fm.init, static_argnames=("train",))(
        {"params": key, "dropout": key, "chunk": key},
        jnp.zeros((2, 67, 80)), jnp.asarray([67, 67]),
        jnp.ones((2, 4), jnp.int32), jnp.asarray([4, 4]), train=False)
    params = torch_default_reinit(v["params"], jax.random.PRNGKey(1))
    return from_flax_variables({"params": jax.device_get(params)}), dec, conf


@pytest.mark.parametrize("family", list(FAMILIES))
def test_torch_default_init_matches_masr_tpu(family):
    """Every parameter of the port's model after torch_default_like_init
    has masr_tpu's torch_default kind (ones, zeros, random); a random one
    of 64 values or more has masr_tpu's spread (std within 0.75-1.33x)
    and bound (largest magnitude within 0.8-1.25x). So pos_bias_u/v are
    xavier_uniform, not 0, and DeepSpeech2's gate matrices draw
    U(±1/√fan_in) with one bias a gate, as masr_tpu's."""
    want, dec, conf = _flax_torch_default(family)
    port = build_model(family, 80, 50,
                       streaming=family != "deepspeech2",
                       encoder_conf=FAMILIES[family], decoder_conf=dec,
                       model_conf=conf)
    torch_default_like_init(port, torch.Generator().manual_seed(0))
    got = {n: p.detach().numpy() for n, p in port.named_parameters()}
    assert set(got) <= set(want)
    bad = {}
    for name, g in got.items():
        w = want[name].numpy()
        if _kind(g) != _kind(w):
            bad[name] = (_kind(g), _kind(w))
        elif _kind(w) == "random" and w.size >= 64:
            std, top = g.std() / w.std(), np.abs(g).max() / np.abs(w).max()
            if not (0.75 < std < 1.33 and 0.8 < top < 1.25):
                bad[name] = (std, top)
    assert not bad, bad
    if family in ("conformer", "efficient_conformer"):
        assert all(_kind(got[n]) == "random" for n in got
                   if n.endswith("pos_bias_u"))
