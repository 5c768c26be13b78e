"""The port's data parallelism (masr_tpu_torch/parallel/mesh.py, the
parallel train step of training/train_state.py, data/sampler.py
ShardedBatchSampler, the global BatchNorm statistics and the kernel
routes' dropout seeds) against masr_tpu's (tests/test_parallel.py,
tests/test_multihost_input.py) and against the port in one process.

The ranks are gloo processes that import torch only
(tests/test_torch_parallel_worker.py), one spawn of two ranks for the
whole file; masr_tpu runs its step on the 8-device virtual CPU mesh
(tests/conftest.py) in this process.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from masr_tpu.data.sampler import ShardedBatchSampler as JSampler
from masr_tpu.models.registry import build_model as build_flax_model
from masr_tpu.optimizer.schedulers import build_optimizer as jbuild_opt
from masr_tpu.parallel.mesh import (make_mesh, replicate,
                                    shard_batch as jshard_batch)
from masr_tpu.training.train_state import TrainState as JState
from masr_tpu.training.train_state import make_train_step
from masr_tpu_torch.data.sampler import ShardedBatchSampler
from masr_tpu_torch.models.weights import (from_flax_variables,
                                           seeded_state_dict,
                                           to_flax_variables)
from masr_tpu_torch.ops.dropout_hash import layer_seeds
from masr_tpu_torch.parallel import mesh
from test_torch_threads import one_torch_thread  # noqa: F401
import test_torch_parallel_worker as W

FEAT, VOCAB = 80, 30
ZERO_DROP = dict(dropout_rate=0.0, positional_dropout_rate=0.0,
                 attention_dropout_rate=0.0)
# tests/test_parallel.py's model, every dropout 0
SMALL = dict(streaming=False,
             encoder_conf=dict(output_size=16, attention_heads=2,
                               linear_units=16, num_blocks=1,
                               cnn_module_kernel=7, **ZERO_DROP),
             decoder_conf=dict(attention_heads=2, linear_units=16,
                               num_blocks=1, r_num_blocks=0,
                               dropout_rate=0.0, positional_dropout_rate=0.0,
                               self_attention_dropout_rate=0.0,
                               src_attention_dropout_rate=0.0),
             model_conf=dict(ctc_weight=0.5, lsm_weight=0.1))
SGD = {"optimizer": "SGD", "momentum": 0.9, "learning_rate": 1e-3,
       "scheduler": "WarmupLR", "scheduler_conf": {"warmup_steps": 5}}
ADAM = {"optimizer": "Adam", "learning_rate": 1e-3, "weight_decay": 1e-6,
        "scheduler": "WarmupLR", "scheduler_conf": {"warmup_steps": 10}}
# the kernel route with dropout on its layers (the plain twin on the CPU)
DROP = dict(SMALL, encoder_conf=dict(SMALL["encoder_conf"], num_blocks=2,
                                     dropout_rate=0.1,
                                     attention_dropout_rate=0.1))
# a BatchNorm Squeezeformer at 2 layers
SQ = dict(streaming=False, no_pos_dropout=True,
          encoder_conf=dict(encoder_dim=16, output_size=16,
                            attention_heads=2, num_blocks=2,
                            reduce_idx=1, recover_idx=1,
                            feed_forward_expansion_factor=2,
                            cnn_module_kernel=7, cnn_norm_type="batch_norm",
                            dropout=0.0, input_dropout_rate=0.0,
                            attention_dropout_rate=0.0,
                            feed_forward_dropout_rate=0.0),
          decoder_conf=dict(SMALL["decoder_conf"]),
          model_conf=dict(ctc_weight=0.5, lsm_weight=0.1))


def _batch(rs, B, T=39, L=3):
    return {"inputs": rs.standard_normal((B, T, FEAT)).astype(np.float32),
            "input_lens": np.full((B,), T, np.int32),
            "labels": rs.randint(1, VOCAB - 2, (B, L)).astype(np.int32),
            "label_lens": np.full((B,), L, np.int32)}


def _conf(base):
    return dict(base, feat=FEAT, vocab=VOCAB)


def _weights(kind, base, seed):
    """The port's seeded state_dict of `kind` (norms, statistics and biases
    away from their init)."""
    return seeded_state_dict(W.build(kind, _conf(base), {}), seed)


def fast_jit(fn, *args):
    """fn compiled for args at XLA's lowest optimisation (a quicker
    compile)."""
    return jax.jit(fn).lower(*args).compile(compiler_options={
        "xla_backend_optimization_level": 0,
        "xla_llvm_disable_expensive_passes": True})


def _masr_mesh_step(state_dict, batch, opt, devices=None):
    """masr_tpu's SGD train step of tests/test_parallel.py on its mesh of
    `devices` (all 8 by default) from the port's weights → (loss, flax
    params after)."""
    fm = build_flax_model("conformer", FEAT, VOCAB, **SMALL)
    params = jax.tree.map(jnp.asarray,
                          to_flax_variables(state_dict)["params"])
    tx, _ = jbuild_opt(opt, grad_clip=5.0, accum_grad=1)
    m8 = make_mesh(devices)
    state = replicate(JState.create(fm.apply, params, tx), m8)
    sharded = jshard_batch(batch, m8)
    rng = jax.random.PRNGKey(0)
    state, m = fast_jit(make_train_step(fm, tx), state, sharded, rng)(
        state, sharded, rng)
    return float(m["loss"]), jax.device_get(state.params)


def _close_to_flax(port_state, flax_params, rtol, atol):
    got = to_flax_variables(port_state)["params"]
    flat = jax.tree_util.tree_flatten_with_path(flax_params)[0]
    assert len(flat) == len(jax.tree_util.tree_leaves(got))
    for path, want in flat:
        node = got
        for k in path:
            node = node[k.key]
        np.testing.assert_allclose(node, np.asarray(want), rtol=rtol,
                                   atol=atol, err_msg=str(path))


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    """One spawn of two gloo ranks running every job of this file →
    (jobs' inputs, [rank 0's results, rank 1's])."""
    rs = np.random.RandomState(1)
    small = _weights("conformer", SMALL, 1)
    drop = _weights("conformer", DROP, 2)
    sq = _weights("squeezeformer", SQ, 3)
    b8 = _batch(rs, 8)
    # ragged: frames past each length zero; rank 1's longest is 27 frames
    b6 = _batch(rs, 6)
    b6["input_lens"][:] = [39, 30, 35, 21, 25, 27]
    b6["inputs"][np.arange(39)[None] >= b6["input_lens"][:, None]] = 0.0
    b3 = _batch(rs, 3)
    accum = [_batch(rs, 4), _batch(rs, 4), _batch(rs, 4), _batch(rs, 4)]
    inputs = dict(small=small, drop=drop, sq=sq, b8=b8, b6=b6, b3=b3,
                  accum=accum)
    jobs = [
        ("dp_sgd", dict(job="steps", kind="conformer", conf=_conf(SMALL),
                        state_dict=small, opt_conf=SGD, batches=[b8])),
        ("ragged", dict(job="steps", kind="conformer", conf=_conf(SMALL),
                        state_dict=small, opt_conf=SGD, batches=[b6],
                        trim=True)),
        ("pad3", dict(job="steps", kind="conformer", conf=_conf(SMALL),
                      state_dict=small, opt_conf=SGD, batches=[b3])),
        ("accum", dict(job="steps", kind="conformer", conf=_conf(SMALL),
                       state_dict=small, opt_conf=ADAM, batches=accum,
                       accum_grad=2)),
        ("nonfinite", dict(job="steps", kind="conformer",
                           conf=_conf(SMALL), state_dict=small,
                           opt_conf=ADAM, batches=[b8, b8], nan=(0, 1))),
        ("seeds", dict(layers=3, B=2, step_seed=1234)),
        ("rows", dict(job="encoder_rows", kind="conformer",
                      conf=_conf(DROP), state_dict=drop, batch=b8, seed=5)),
        ("bn", dict(job="grads", kind="squeezeformer", conf=_conf(SQ),
                    state_dict=sq, batch=b8, seed=0)),
    ]
    return inputs, W.launch(tmp_path_factory.mktemp("world2"), 2, jobs)


def test_data_parallel_step_matches_masr_tpu_mesh(world2):
    """tests/test_parallel.py's step: two ranks of 4 rows each, SGD, equal
    masr_tpu's step on its 8-device mesh from the same weights: loss <
    1e-5 off (its test: 1e-3), params rtol 1e-4 atol 1e-5; both ranks
    hold the same parameters."""
    inputs, res = world2
    loss, params = _masr_mesh_step(inputs["small"], inputs["b8"], SGD)
    r0, r1 = res[0]["dp_sgd"], res[1]["dp_sgd"]
    for r in (r0, r1):
        assert abs(r["metrics"][0]["loss"] - loss) < 1e-5
    _close_to_flax(r0["params"], params, 1e-4, 1e-5)
    for k, v in r0["params"].items():
        assert torch.equal(v, r1["params"][k]), k


def test_data_parallel_step_matches_one_process(world2):
    """The same step in one process of the port (8 rows): loss within
    1e-6, params within 1e-6."""
    inputs, res = world2
    one = W.steps("conformer", _conf(SMALL), inputs["small"], SGD,
                  [inputs["b8"]])
    assert abs(res[0]["dp_sgd"]["metrics"][0]["loss"]
               - one["metrics"][0]["loss"]) < 1e-6
    for k, v in one["params"].items():
        torch.testing.assert_close(res[0]["dp_sgd"]["params"][k], v,
                                   rtol=0, atol=1e-6)


def test_shard_batch_pads_with_empty_rows(world2):
    """3 rows over 2 ranks: shard_batch adds one zero row of zero lengths
    (tests/test_parallel.py:56; 6 rows over 4 ranks: masr_tpu's rows), and
    the 2-rank step over it equals masr_tpu's step on a 2-device mesh,
    which pads the same way: the empty row counts in the mean loss as
    there (loss < 1e-5, params rtol 1e-4 atol 1e-5)."""
    inputs, res = world2
    b6 = inputs["b6"]
    got = [mesh.shard_batch(b6, r, 4) for r in range(4)]
    assert [g["inputs"].shape[0] for g in got] == [2, 2, 2, 2]
    assert list(got[3]["input_lens"]) == [0, 0]
    assert not got[3]["inputs"].any()
    want = np.asarray(jshard_batch(b6, make_mesh())["input_lens"])
    assert list(np.concatenate([g["input_lens"] for g in got])) == \
        list(want[:8])
    t = mesh.shard_batch({k: torch.as_tensor(v) for k, v in b6.items()},
                         3, 4)
    assert t["inputs"].shape == (2, 39, FEAT) and not t["inputs"].any()
    rows = mesh.shard_batch(inputs["b3"], 1, 2)
    assert list(rows["input_lens"]) == [39, 0]
    loss, params = _masr_mesh_step(inputs["small"], inputs["b3"], SGD,
                                   jax.devices()[:2])
    r = res[0]["pad3"]
    assert abs(r["metrics"][0]["loss"] - loss) < 1e-5
    _close_to_flax(r["params"], params, 1e-4, 1e-5)


def test_ranks_pad_to_a_common_length(world2):
    """Rank 0's rows hold 39 frames, rank 1's 27: each rank pads to the
    longest of both, so the 2-rank step equals one process's step on the
    whole (zero-padded) batch: loss and params within 1e-6."""
    inputs, res = world2
    one = W.steps("conformer", _conf(SMALL), inputs["small"], SGD,
                  [inputs["b6"]])
    assert abs(res[0]["ragged"]["metrics"][0]["loss"]
               - one["metrics"][0]["loss"]) < 1e-6
    for k, v in one["params"].items():
        torch.testing.assert_close(res[1]["ragged"]["params"][k], v,
                                   rtol=0, atol=1e-6)


def test_accumulation_syncs_and_updates_at_the_boundary(world2):
    """accum_grad=2 (tests/test_parallel.py:104): the parameters stay put
    after micro-steps 1 and 3 and move after 2 and 4, on both ranks alike,
    to one process's values (Adam: 1e-5)."""
    inputs, res = world2
    r0, r1 = res[0]["accum"], res[1]["accum"]
    one = W.steps("conformer", _conf(SMALL), inputs["small"], ADAM,
                  inputs["accum"], accum_grad=2)
    key = "encoder.encoders.0.feed_forward.w_1.weight"
    start = inputs["small"][key]
    seq = [p[key] for p in r0["params_per_step"]]
    assert torch.equal(seq[0], start) and not torch.equal(seq[1], start)
    assert torch.equal(seq[2], seq[1]) and not torch.equal(seq[3], seq[2])
    assert r0["updates"] == r1["updates"] == one["updates"] == 2
    for i, p in enumerate(one["params_per_step"]):
        for k, v in p.items():
            torch.testing.assert_close(r0["params_per_step"][i][k], v,
                                       rtol=0, atol=1e-5)
            assert torch.equal(r0["params_per_step"][i][k],
                               r1["params_per_step"][i][k])


def test_one_rank_non_finite_skips_every_rank(world2):
    """Rank 1's rows are NaN at step 1: every rank reports the step non
    finite and keeps its parameters (masr_tpu's global loss is NaN), and
    step 2 updates both ranks alike."""
    inputs, res = world2
    for r in res:
        nf = r["nonfinite"]
        assert nf["metrics"][0]["finite"] is False
        assert nf["metrics"][1]["finite"] is True
        for k, v in nf["params_per_step"][0].items():
            assert torch.equal(v, inputs["small"][k]), k
    key = "encoder.encoders.0.self_attn.linear_q.weight"
    a = res[0]["nonfinite"]["params"][key]
    assert torch.equal(a, res[1]["nonfinite"]["params"][key])
    assert not torch.equal(a, inputs["small"][key])


def test_layer_seeds_follow_the_row(world2):
    """A row's per-layer seeds are the same over two ranks as in one
    process (each rank takes its columns of the global draw), after a
    step-generator draw whose size follows the rank's batch."""
    _, res = world2
    g = torch.Generator().manual_seed(1234)
    torch.rand(4, 5, generator=g)
    want = layer_seeds(3, 4, g, "cpu")
    got = torch.cat([res[0]["seeds"], res[1]["seeds"]], dim=1)
    assert torch.equal(got, want)


def test_kernel_route_dropout_rows_match_one_process(world2):
    """Dropout 0.1 on the layers of the kernel route (its plain twin
    here): each rank's encoder rows equal the rows of one process's
    encode of the whole batch (the same seeds, so the same masks), 1e-6."""
    inputs, res = world2
    one, _ = W.encoder_rows("conformer", _conf(DROP), inputs["drop"],
                            inputs["b8"], seed=5)
    got = torch.cat([res[0]["rows"][0], res[1]["rows"][0]])
    torch.testing.assert_close(got, one, rtol=0, atol=1e-6)
    no_drop, _ = W.encoder_rows("conformer", _conf(dict(
        DROP, encoder_conf=dict(DROP["encoder_conf"], **ZERO_DROP))),
        inputs["drop"], inputs["b8"], seed=5)
    assert (no_drop - one).abs().max() > 1e-2


def test_batch_norm_statistics_span_the_ranks(world2):
    """A BatchNorm Squeezeformer at 2 layers: the 2-rank step's loss, every
    grad (averaged over the ranks) and the running statistics equal one
    process's step on the whole batch (1e-5): the statistics span both
    ranks' rows."""
    inputs, res = world2
    one = W.grads("squeezeformer", _conf(SQ), inputs["sq"], inputs["b8"])
    two = res[0]["bn"]
    assert abs(two["loss"] - one["loss"]) < 1e-5
    assert one["buffers"] and set(two["buffers"]) == set(one["buffers"])
    for k, v in one["buffers"].items():
        torch.testing.assert_close(two["buffers"][k], v, rtol=1e-5,
                                   atol=1e-6)
        assert torch.equal(two["buffers"][k], res[1]["bn"]["buffers"][k])
    for k, v in one["grads"].items():
        torch.testing.assert_close(two["grads"][k], v, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("size,batch,replicas,drop_last,seed",
                         [(24, 2, 2, True, 7), (40, 3, 4, True, 0),
                          (17, 2, 3, False, 5)])
def test_sharded_sampler_matches_masr_tpu(size, batch, replicas, drop_last,
                                          seed):
    """ShardedBatchSampler yields masr_tpu's batches for the same
    arguments over three epochs (sortagrad epoch 0, then reshuffled):
    disjoint over the ranks, one global order per epoch
    (tests/test_multihost_input.py:49, :113)."""
    for epoch in range(3):
        seen = []
        for r in range(replicas):
            kw = dict(rank=r, num_replicas=replicas, sortagrad=True,
                      drop_last=drop_last, seed=seed)
            a, b = ShardedBatchSampler(size, batch, **kw), \
                JSampler(size, batch, **kw)
            a.set_epoch(epoch)
            b.set_epoch(epoch)
            got = list(a)
            assert got == list(b) and len(got) == len(a) == len(b)
            seen.extend(i for bt in got for i in bt)
        assert len(seen) == len(set(seen))


def test_sharded_sampler_keeps_the_ranks_in_step():
    """10 utterances over 3 ranks in batches of 1: rank 0's strided share
    holds 4, the others' 3; every rank yields len() = 3 batches (masr_tpu's
    rank 0 yields 4, and its collectives would wait on the others)."""
    counts = [len(list(ShardedBatchSampler(10, 1, rank=r, num_replicas=3,
                                           sortagrad=False, seed=1)))
              for r in range(3)]
    assert counts == [3, 3, 3]
    assert len(list(JSampler(10, 1, rank=0, num_replicas=3,
                             sortagrad=False, seed=1))) == 4


def test_one_process_makes_no_group(monkeypatch):
    """WORLD_SIZE unset or 1: no process group, a grid of one rank and
    no active grid; a world that tensor_parallel does not divide
    raises."""
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert mesh.maybe_init_distributed("cpu") == (0, 1)
    assert not torch.distributed.is_initialized()
    g = mesh.make_mesh()
    assert (g.rank, g.world, g.tp, g.distributed) == (0, 1, 1, False)
    with mesh.step_grid(g):
        assert mesh.active() is None and mesh.batch_shard() == (0, 1)
    with pytest.raises(ValueError, match="tensor_parallel=2"):
        mesh.make_mesh_2d(2)
