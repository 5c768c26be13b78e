"""The port's tensor parallelism (masr_tpu_torch/parallel/tp.py, the
dp x tp step of training/train_state.py, MASRTrainer with
train_conf.tensor_parallel) against masr_tpu's (tests/test_tensor_parallel.py)
and against the port in one process.

The ranks are gloo processes that import torch only
(tests/test_torch_parallel_worker.py): one spawn of two ranks (tp = 2),
one of four (dp = 2 x tp = 2), one of two trainer ranks. masr_tpu runs
its make_mesh_2d(2) step on the 8-device virtual CPU mesh
(tests/conftest.py) in this process.
"""
import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import PartitionSpec as P

from masr_tpu.models.registry import build_model as build_flax_model
from masr_tpu.optimizer.schedulers import build_optimizer as jbuild_opt
from masr_tpu.parallel.mesh import shard_batch as jshard_batch
from masr_tpu.parallel.tp import make_mesh_2d as jmesh_2d
from masr_tpu.parallel.tp import param_shardings as jparam_shardings
from masr_tpu.parallel.tp import shard_train_state
from masr_tpu.training.train_state import TrainState as JState
from masr_tpu.training.train_state import make_train_step
from masr_tpu_torch.models.weights import (_kind, seeded_state_dict,
                                           to_flax_variables)
from masr_tpu_torch.parallel.tp import param_shardings
from test_torch_threads import one_torch_thread  # noqa: F401
import test_torch_parallel_worker as W

FEAT, VOCAB = 80, 50
# tests/test_tensor_parallel.py's model
TP_MODEL = dict(
    streaming=False,
    encoder_conf=dict(output_size=32, attention_heads=2, linear_units=64,
                      num_blocks=2, cnn_module_kernel=7, dropout_rate=0.0,
                      positional_dropout_rate=0.0,
                      attention_dropout_rate=0.0),
    decoder_conf=dict(attention_heads=2, linear_units=64, num_blocks=1,
                      r_num_blocks=0, dropout_rate=0.0,
                      positional_dropout_rate=0.0,
                      self_attention_dropout_rate=0.0,
                      src_attention_dropout_rate=0.0),
    model_conf=dict(ctc_weight=0.5, lsm_weight=0.1))
ADAM = {"optimizer": "Adam", "learning_rate": 1e-3, "weight_decay": 1e-6,
        "scheduler": "WarmupLR", "scheduler_conf": {"warmup_steps": 10}}


def _conf():
    return dict(TP_MODEL, feat=FEAT, vocab=VOCAB)


def _batch():
    rs = np.random.RandomState(0)
    B, T, L = 8, 95, 6
    return {"inputs": rs.standard_normal((B, T, FEAT)).astype(np.float32),
            "input_lens": np.full((B,), T, np.int64),
            "labels": rs.randint(2, VOCAB - 1, (B, L)).astype(np.int32),
            "label_lens": np.full((B,), L, np.int64)}


def fast_jit(fn, *args):
    """fn compiled for args at XLA's lowest optimisation (a quicker
    compile)."""
    return jax.jit(fn).lower(*args).compile(compiler_options={
        "xla_backend_optimization_level": 0,
        "xla_llvm_disable_expensive_passes": True})


def _flax_path(name, w):
    """The flax path of the port's parameter `name` (weights.py's map)."""
    tree = to_flax_variables({name: w})["params"]
    (path, _), = jax.tree_util.tree_flatten_with_path(tree)[0]
    return "/".join(k.key for k in path)


def _flax_dim(name, spec):
    """The torch dim of a flax PartitionSpec's model axis (None: whole): a
    Linear weight is the transposed kernel."""
    if "model" not in tuple(spec):
        return None
    a = tuple(spec).index("model")
    return 1 - a if _kind(name) == "linear" else a


@pytest.fixture(scope="module")
def weights():
    return seeded_state_dict(W.build("conformer", _conf(), {}), 4)


@pytest.fixture(scope="module")
def masr_tp_run(weights):
    """masr_tpu's Adam steps (two, the same batch) on its make_mesh_2d(2)
    mesh (data 4 x model 2) → [loss per step], flax params after."""
    fm = build_flax_model("conformer", FEAT, VOCAB, **TP_MODEL)
    params = jax.tree.map(jnp.asarray, to_flax_variables(weights)["params"])
    tx, _ = jbuild_opt(ADAM, grad_clip=5.0, accum_grad=1)
    mesh = jmesh_2d(tensor_parallel=2)
    state = shard_train_state(JState.create(fm.apply, params, tx), mesh)
    rng = jax.random.PRNGKey(0)
    losses = []
    with mesh:
        sharded = jshard_batch(_batch(), mesh)
        step = fast_jit(make_train_step(fm, tx), state, sharded, rng)
        for _ in range(2):
            state, m = step(state, sharded, rng)
            losses.append(float(m["loss"]))
    return losses, jax.device_get(state.params)


@pytest.fixture(scope="module")
def tp_runs(weights, tmp_path_factory):
    """The port's two Adam steps at tp = 2 (2 ranks) and dp = 2 x tp = 2 (4
    ranks) → {world: [rank results]}."""
    job = ("steps", dict(kind="conformer", conf=_conf(), state_dict=weights,
                         opt_conf=ADAM, batches=[_batch(), _batch()], tp=2))
    return {w: [r["steps"] for r in W.launch(
        tmp_path_factory.mktemp(f"tp{w}"), w, [job])] for w in (2, 4)}


def _close_to_flax(port_state, flax_params, atol):
    got = to_flax_variables(port_state)["params"]
    worst = 0.0
    for path, want in jax.tree_util.tree_flatten_with_path(flax_params)[0]:
        node = got
        for k in path:
            node = node[k.key]
        worst = max(worst, float(np.abs(node - np.asarray(want)).max()))
    assert worst < atol, worst


@pytest.mark.parametrize("tp", [2, 8])
def test_param_shardings_split_masr_tpu_leaves(weights, tp):
    """param_shardings splits the leaves masr_tpu's param_shardings splits
    (flax path ↔ upstream name; the model axis of the flax spec ↔ the torch
    dim, transposed for a Linear weight): at tp = 2 the q / k / v / pos,
    out, w_1, w_2 projections and pos_bias of encoder and decoder; at tp =
    8 pos_bias (2 heads) and the 32-wide attention stay whole while the
    64-wide w_1 splits (tests/test_tensor_parallel.py:82)."""
    model = W.build("conformer", _conf(), weights)
    fv = to_flax_variables(weights)["params"]
    specs = {"/".join(k.key for k in p): s.spec for p, s in
             jax.tree_util.tree_flatten_with_path(jparam_shardings(
                 fv, jmesh_2d(tensor_parallel=tp)))[0]}
    dims = param_shardings(model, tp)
    assert len(dims) == len(specs)
    for name, d in dims.items():
        path = _flax_path(name, weights[name])
        assert d == _flax_dim(name, specs[path]), (name, path, specs[path])
    enc = "encoder.encoders.0."
    if tp == 2:
        assert dims[enc + "self_attn.linear_q.weight"] == 0
        assert dims[enc + "self_attn.linear_out.weight"] == 1
        assert dims[enc + "feed_forward.w_2.weight"] == 1
        assert dims[enc + "self_attn.pos_bias_u"] == 0
        assert dims[enc + "norm_mha.weight"] is None
        assert any(dims[n] == 0 for n in dims
                   if "left_decoder" in n and n.endswith("linear_k.weight"))
    else:
        assert dims[enc + "self_attn.pos_bias_u"] is None
        assert specs["encoder/layer_0/self_attn/pos_bias_u"] == P()
        assert dims[enc + "feed_forward.w_1.weight"] == 0


@pytest.mark.parametrize("world", [2, 4])
def test_tp_steps_match_masr_tpu_mesh(masr_tp_run, tp_runs, world):
    """Two Adam steps at tp = 2 over 2 ranks and over dp = 2 x tp = 2 = 4
    ranks equal masr_tpu's make_mesh_2d(2) steps from the same weights:
    each loss within rel 2e-6 (masr_tpu's own test: 1e-3), every parameter
    < 1e-4 (as tests/test_tensor_parallel.py:128-133); every rank holds the
    same parameters."""
    losses, params = masr_tp_run
    runs = tp_runs[world]
    for r in runs:
        got = [m["loss"] for m in r["metrics"]]
        np.testing.assert_allclose(got, losses, rtol=2e-6)
    _close_to_flax(runs[0]["params"], params, 1e-4)
    for r in runs[1:]:
        for k, v in runs[0]["params"].items():
            assert torch.equal(v, r["params"][k]), k


@pytest.mark.parametrize("world", [2, 4])
def test_ruled_adam_moments_are_slices(weights, tp_runs, world):
    """Each ruled parameter's Adam moments on a rank hold half its
    elements (the rank's slice along its split dim), the rest whole; the
    gathered moments of the state_dict are whole and equal one process's
    (1e-6)."""
    model = W.build("conformer", _conf(), weights)
    dims = param_shardings(model, 2)
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    for r in tp_runs[world]:
        mom = r["moments"]
        assert set(mom) == set(shapes)
        for name, d in dims.items():
            want = list(shapes[name])
            if d is not None:
                want[d] //= 2
            assert mom[name] == tuple(want), name
        assert sum(d is not None for d in dims.values()) >= 20
    one = W.steps("conformer", _conf(), weights, ADAM,
                  [_batch(), _batch()])
    got = tp_runs[world][0]["state_dict"]["optimizer"]["state"]
    for i, st in one["state_dict"]["optimizer"]["state"].items():
        for k in ("exp_avg", "exp_avg_sq"):
            torch.testing.assert_close(got[i][k], st[k], rtol=0, atol=1e-6)


# ---------------------------------------------------------------------- #
# the trainer
# ---------------------------------------------------------------------- #
def _corpus_config(root, batch_size, tp, max_epoch, ext=".feature"):
    """The trainers' config: the feature slabs' manifests (ext), whose
    features carry no train-time dither, so two runs see the same rows."""
    return {
        "use_model": "conformer", "streaming": False,
        "decoder": "ctc_greedy", "metrics_type": "cer", "seed": 0,
        "encoder_conf": dict(TP_MODEL["encoder_conf"], num_blocks=1),
        "decoder_conf": TP_MODEL["decoder_conf"],
        "model_conf": TP_MODEL["model_conf"],
        "dataset_conf": {
            "batch_size": batch_size, "num_workers": 1, "min_duration": 0,
            "max_duration": 20,
            "train_manifest": f"{root}/dataset/manifest.train{ext}",
            "test_manifest": f"{root}/dataset/manifest.test{ext}",
            "dataset_vocab": f"{root}/dataset/vocabulary.txt",
            "mean_istd_path": f"{root}/dataset/mean_istd.json",
            "manifest_type": "txt"},
        "preprocess_conf": {"feature_method": "fbank", "n_mels": 80,
                            "sample_rate": 16000,
                            "use_dB_normalization": True, "target_dB": -20},
        "optimizer_conf": ADAM,
        "train_conf": {"enable_amp": False, "grad_clip": 5.0,
                       "accum_grad": 1, "max_epoch": max_epoch,
                       "log_interval": 1, "tensor_parallel": tp},
        "log_dir": f"{root}/log_tp{tp}",
    }


@pytest.fixture(scope="module")
def trainer_runs(tmp_path_factory):
    """tests/test_tensor_parallel.py:172's corpus; one epoch of
    MASRTrainer with tensor_parallel 2 on 2 gloo ranks (batch 2 a rank)
    and one of MASRTrainer in one process (batch 4: the same 4
    utterances a step) → (root, the ranks' results, the two save
    paths)."""
    from masr_tpu_torch.audio.io import write_wave
    from masr_tpu_torch.training.trainer import MASRTrainer
    root = str(tmp_path_factory.mktemp("tp_trainer"))
    os.makedirs(f"{root}/dataset/annotation")
    rs = np.random.RandomState(0)
    lines = []
    for i, text in enumerate(["你好", "天气", "你好天气", "好天"] * 2):
        n = int(16000 * (0.7 + 0.05 * i))
        sig = (0.2 * np.sin(2 * np.pi * (200 + 50 * i)
                            * np.arange(n) / 16000)
               + 0.01 * rs.standard_normal(n)).astype(np.float32)
        p = f"{root}/u{i}.wav"
        write_wave(p, sig, 16000)
        lines.append(f"{p}\t{text}")
    with open(f"{root}/dataset/annotation/train.txt", "w",
              encoding="utf-8") as f:
        f.write("\n".join(lines))
    with open(f"{root}/dataset/annotation/test.txt", "w",
              encoding="utf-8") as f:
        f.write("\n".join(lines[:2]))
    prep = MASRTrainer(_corpus_config(root, 4, 1, 1, ext=""), device="cpu")
    prep.create_data(annotation_path=f"{root}/dataset/annotation",
                     noise_dir=None, num_samples=-1, count_threshold=1)
    prep.extract_features(save_dir=f"{root}/dataset/features")
    one = MASRTrainer(_corpus_config(root, 4, 1, 1), device="cpu")
    one.train(save_model_path=f"{root}/one", augment_conf_path=None)
    res = W.launch(f"{root}", 2, [("trainer", dict(
        config=_corpus_config(root, 2, 2, 1),
        save_model_path=f"{root}/tp"))])
    return root, [r["trainer"] for r in res], f"{root}/one", f"{root}/tp"


def _ckpt(save, epoch):
    from masr_tpu_torch.training import checkpoints as ckpt
    return ckpt.load_checkpoint(
        f"{save}/conformer_non-streaming_fbank/epoch_{epoch}")


def test_trainer_trains_with_tensor_parallel(trainer_runs):
    """MASRTrainer with tensor_parallel 2 on 2 gloo ranks: both ranks train
    the epoch's 2 steps with finite losses in one grid (rank 0 writes the
    scalars), and rank 0 alone writes one checkpoint, evaluated, with whole
    parameters and whole Adam moments."""
    root, ranks, _, tp_save = trainer_runs
    assert [(r["rank"], r["world"], r["tp"], r["step"]) for r in ranks] \
        == [(0, 2, 2, 2), (1, 2, 2, 2)]
    with open(f"{root}/log_tp2/scalars.jsonl", encoding="utf-8") as f:
        points = [json.loads(l) for l in f]
    losses = [p["value"] for p in points if p["tag"] == "Train/Loss"]
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert any(p["tag"] == "Test/cer" for p in points)
    run = f"{tp_save}/conformer_non-streaming_fbank"
    assert sorted(os.listdir(run)) == ["best_model", "epoch_1",
                                       "last_model"]
    state, meta = _ckpt(tp_save, 1)
    assert meta["last_epoch"] == 1
    model = state["model"]
    q = "encoder.encoders.0.self_attn.linear_q.weight"
    assert tuple(model[q].shape) == (32, 32)
    shapes = [tuple(s["exp_avg"].shape) for s in
              state["optimizer"]["state"].values()]
    assert (32, 32) in shapes and (64, 32) in shapes


def test_tp_checkpoint_equals_one_process_and_resumes(trainer_runs):
    """The tp run's checkpoint equals one process's run of the same steps
    (the same 4 utterances a step): parameters and Adam moments within
    1e-4; loaded into one process it resumes (a second epoch), and the
    result equals the one-process run resumed the same way, within
    1e-4."""
    from masr_tpu_torch.training.trainer import MASRTrainer
    root, _, one_save, tp_save = trainer_runs
    a, _ = _ckpt(tp_save, 1)
    b, _ = _ckpt(one_save, 1)
    assert a["step"] == b["step"] == 2
    for k, v in b["model"].items():
        torch.testing.assert_close(a["model"][k], v, rtol=0, atol=1e-4)
    for i, st in b["optimizer"]["state"].items():
        for k in ("exp_avg", "exp_avg_sq"):
            torch.testing.assert_close(a["optimizer"]["state"][i][k], st[k],
                                       rtol=0, atol=1e-4)
    finals = []
    for save in (tp_save, one_save):
        tr = MASRTrainer(_corpus_config(root, 4, 1, 2), device="cpu")
        tr.train(save_model_path=save, augment_conf_path=None)
        assert tr.state.step == 4
        finals.append(_ckpt(save, 2)[0]["model"])
    for k, v in finals[1].items():
        torch.testing.assert_close(finals[0][k], v, rtol=0, atol=1e-4)
