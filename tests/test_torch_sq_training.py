"""The port's Squeezeformer training path against masr_tpu on the CPU, at
the sizes of tests/test_fused_sq_train.py (D=16, 2 heads, FFN expansion 2,
conv 7, B=2 with ragged lengths) and 3-4 blocks with reduce 1 / recover 2
or 3, every parameter and BatchNorm statistic perturbed away from its init:

- SqueezeformerModel.forward (train mode, dropout 0): the loss dict and
  every parameter grad against jax.value_and_grad of masr_tpu's
  SqueezeformerModel, for both conv norms (layer_norm: the training-layer
  route; the BatchNorm default: the eager layers with batch statistics) and
  both time reductions (causal with `stream` under a dynamic chunk mask,
  non-causal with `conv1d`), T' odd before the reduction; the BatchNorm
  running statistics after the step against flax's updated batch_stats;
The encoder through reduce / recover, the initializer families and a CPU
MASRTrainer run are in tests/test_torch_sq_trainer.py. Each tolerance is
stated where it is used.

The fixture `deterministic` fixes both packages' dynamic chunk and turns
the subsampling's positional dropout off; tests/test_torch_sq_trainer.py
takes it from here."""
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import masr_tpu.models.squeezeformer as jsq
import masr_tpu_torch.models.squeezeformer as tsq
from masr_tpu.models.registry import build_model as build_flax_model
from masr_tpu_torch.models.registry import build_model
from masr_tpu_torch.models.weights import (from_flax_variables,
                                           grads_to_flax_variables,
                                           to_flax_variables)
from test_torch_threads import one_torch_thread  # noqa: F401

FEAT, VOCAB, D = 20, 12, 16
ENC = dict(encoder_dim=D, output_size=D, attention_heads=2, num_blocks=3,
           reduce_idx=1, recover_idx=2, feed_forward_expansion_factor=2,
           cnn_module_kernel=7, dropout=0.0, input_dropout_rate=0.0,
           attention_dropout_rate=0.0, feed_forward_dropout_rate=0.0)
DEC = dict(attention_heads=2, linear_units=40, num_blocks=1, r_num_blocks=1,
           dropout_rate=0.0, positional_dropout_rate=0.0)
MODEL_CONF = dict(ctc_weight=0.3, lsm_weight=0.1, reverse_weight=0.3)
# the dynamic chunk both packages draw from their own generators, fixed
# here to 4-frame chunks with 2 left chunks at every rate
CHUNK, LEFT = 4, 2


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _perturb(variables, seed, scale=0.05):
    """Every leaf moved off its init: ones (scales, BatchNorm variances)
    by +|N|·scale, the rest by N·scale."""
    rs = np.random.RandomState(seed)
    leaves, treedef = jax.tree.flatten(variables)
    return jax.tree.unflatten(treedef, [
        (np.asarray(l) + (np.abs(rs.standard_normal(l.shape))
                          if l.size and float(np.min(l)) >= 0.9
                          else rs.standard_normal(l.shape)) * scale
         ).astype(np.float32) for l in leaves])


@pytest.fixture
def deterministic(monkeypatch):
    """Both packages' training draws replaced by the fixed chunk, and the
    subsampling's positional dropout, which masr_tpu's encoder leaves at
    0.1 whatever its config, set to 0 in both."""
    j_orig, t_orig = jsq.add_optional_chunk_mask, tsq.add_optional_chunk_mask

    def j_fixed(xs_len, masks, dyn, dyn_left, dcs, scs, left, rng=None):
        return j_orig(xs_len, masks, dyn, dyn_left,
                      CHUNK if dyn and dcs == 0 else dcs, scs,
                      LEFT if dyn and dcs == 0 else left)

    def t_fixed(xs_len, masks, dyn, dyn_left, dcs, scs, left,
                generator=None):
        return t_orig(xs_len, masks, dyn, dyn_left,
                      CHUNK if dyn and dcs == 0 else dcs, scs,
                      LEFT if dyn and dcs == 0 else left)

    monkeypatch.setattr(jsq, "add_optional_chunk_mask", j_fixed)
    monkeypatch.setattr(tsq, "add_optional_chunk_mask", t_fixed)
    monkeypatch.setattr(jsq, "DepthwiseConv2dSubsampling4",
                        functools.partial(jsq.DepthwiseConv2dSubsampling4,
                                          pos_dropout_rate=0.0))
    port_subsampling = tsq.DepthwiseConv2dSubsampling4

    def port_fixed(*args, **kwargs):
        m = port_subsampling(*args, **kwargs)
        m.pos_enc.dropout_rate = 0.0
        return m

    monkeypatch.setattr(tsq, "DepthwiseConv2dSubsampling4", port_fixed)


def _assert_tree(got, want, rtol, atol):
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    assert len(flat) == len(jax.tree_util.tree_leaves(got))
    for path, w in flat:
        node = got
        for k in path:
            node = node[k.key]
        np.testing.assert_allclose(node, np.asarray(w), rtol=rtol, atol=atol,
                                   err_msg=jax.tree_util.keystr(path))


# --------------------------------------------------------------------------- #
# the whole model: loss dict, every grad, the BatchNorm statistics
# --------------------------------------------------------------------------- #
def _model_batch(rs):
    """71 and 50 input frames: T' = 17 and 11 after the subsampling, odd
    before the time reduction."""
    speech = rs.standard_normal((2, 71, FEAT)).astype(np.float32)
    lens = np.asarray([71, 50], np.int32)
    text = rs.randint(1, VOCAB - 1, (2, 6)).astype(np.int32)
    tlens = np.asarray([6, 3], np.int32)
    text[1, 3:] = -1
    return speech, lens, text, tlens


@pytest.mark.parametrize("conv_norm", ["layer_norm", "batch_norm"])
@pytest.mark.parametrize("streaming", [True, False],
                         ids=["causal_stream_reduction",
                              "full_context_conv1d_reduction"])
def test_model_loss_grads_and_batch_stats_match_flax(deterministic, conv_norm,
                                                     streaming):
    """SqueezeformerModel.forward (train mode, dropout 0) == jax.value_and_
    grad of masr_tpu's SqueezeformerModel: loss, loss_att, loss_ctc,
    acc_att rtol 1e-5; every parameter grad rtol 1e-4, atol 2e-5 (f32,
    other sum orders); with the BatchNorm conv the running mean and
    variance after the step == flax's updated batch_stats, rtol 1e-5 atol
    1e-6 (flax takes the variance as E[x^2] - E[x]^2)."""
    enc = dict(ENC, cnn_norm_type=conv_norm)
    rs = np.random.RandomState(3)
    fm = build_flax_model("squeezeformer", FEAT, VOCAB, streaming=streaming,
                          encoder_conf=enc, decoder_conf=DEC,
                          model_conf=MODEL_CONF)
    speech, lens, text, tlens = _model_batch(rs)
    args = [jnp.asarray(a) for a in (speech, lens, text, tlens)]
    key = jax.random.PRNGKey(0)
    v = jax.jit(fm.init, static_argnames=("train",))(
        {"params": key, "dropout": key, "chunk": key}, *args, train=False)
    v = _perturb(dict(v), 4)
    stats = v.get("batch_stats")

    def loss(p):
        variables = {"params": p}
        kw = {}
        if stats is not None:
            variables["batch_stats"] = stats
            kw["mutable"] = ["batch_stats"]
        out = fm.apply(variables, *args, train=True,
                       rngs={"dropout": jax.random.PRNGKey(1),
                             "chunk": jax.random.PRNGKey(2)}, **kw)
        out, upd = out if stats is not None else (out, {})
        return out["loss"], (out, upd)

    (_, (want, upd)), gp = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        v["params"])
    port = build_model("squeezeformer", FEAT, VOCAB, streaming=streaming,
                       encoder_conf=enc, decoder_conf=DEC,
                       model_conf=MODEL_CONF)
    missing, unexpected = port.load_state_dict(from_flax_variables(v),
                                               strict=False)
    assert not unexpected
    assert all(k.endswith("num_batches_tracked") for k in missing)
    out = port.train()(_t(speech), _t(lens).long(), _t(text).long(),
                       _t(tlens).long(),
                       generator=torch.Generator().manual_seed(5),
                       chunk_generator=torch.Generator().manual_seed(6))
    out["loss"].backward()
    for k in ("loss", "loss_att", "loss_ctc", "acc_att"):
        np.testing.assert_allclose(float(out[k].detach()), float(want[k]),
                                   rtol=1e-5, err_msg=k)
    _assert_tree(grads_to_flax_variables(port.named_parameters())["params"],
                 gp, rtol=1e-4, atol=2e-5)
    if stats is not None:
        got = to_flax_variables(port.state_dict())["batch_stats"]
        _assert_tree(got, upd["batch_stats"], rtol=1e-5, atol=1e-6)
        moved = jax.tree.map(lambda a, b: float(np.abs(
            np.asarray(a) - np.asarray(b)).max()), upd["batch_stats"], stats)
        assert min(jax.tree.leaves(moved)) > 1e-4
