"""The port's Squeezeformer streaming chunk layer
(masr_tpu_torch/ops/cuda/chunk_layer_sq.py) and chunk encoder against
masr_tpu, on the CPU, at D=64, 2 heads, FFN 128, conv kernel 7, every
parameter and BatchNorm statistic perturbed away from its init.

- The plain twin against the Pallas kernel `fused_chunk_layer_sq` in
  interpret mode, at full rate (c, C) and half rate (c/2, C/2, the port's
  ring rows stored twice), n_sub 1 and 2, cache_len 0, partial and full,
  write pointers that wrap the ring, an inactive slot: outputs and new
  caches carried between the two layouts by models/weights.py, atol 1e-4
  (f32, another sum order, the adaptive scales folded into the weights);
  the inactive slot's caches bitwise unchanged.
- The port's eager cached layer against the flax layer with caches, and
  the kernel route (plain on the CPU) against the eager layer: atol 1e-5.
- Chained forward_chunk and staggered forward_chunk_batched (single and
  multi-chunk ticks) against masr_tpu's forward_chunk chains (XLA path),
  with the time reduction at layer 1 and the recover at layer 2: atol 1e-5.
The CUDA kernel is held against the plain twin in
tests/test_torch_cuda_kernels.py.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from masr_tpu.models.attention import cache_key_mask as jax_cache_key_mask
from masr_tpu.models.squeezeformer import SqueezeformerEncoder as FlaxEncoder
from masr_tpu.models.squeezeformer import \
    SqueezeformerEncoderLayer as FlaxLayer
from masr_tpu.ops.pallas import chunk_layer_sq as jck
from masr_tpu.ops.pallas.squeezeformer_layer import pack_sq_layer_params
from masr_tpu_torch.models.attention import cache_key_mask
from masr_tpu_torch.models.squeezeformer import (SqueezeformerEncoder,
                                                 SqueezeformerEncoderLayer)
from masr_tpu_torch.models.weights import (from_flax_variables,
                                           right_aligned_from_ring,
                                           ring_from_right_aligned)
from masr_tpu_torch.ops.cuda import chunk_layer_sq as ck
from test_torch_threads import one_torch_thread  # noqa: F401

D, H, FF, K = 64, 2, 128, 7
d_k = D // H


def _perturb(variables, seed, scale=0.05):
    """Ones (scales, BatchNorm variances) move by +|N|·scale, the rest by
    N·scale."""
    rs = np.random.RandomState(seed)
    leaves, treedef = jax.tree.flatten(variables)
    return jax.tree.unflatten(treedef, [
        (np.asarray(l) + (np.abs(rs.standard_normal(l.shape))
                          if l.size and float(np.min(l)) >= 0.9
                          else rs.standard_normal(l.shape)) * scale
         ).astype(np.float32) for l in leaves])


def _load(module, variables, prefix):
    sd = {k[len(prefix):]: v for k, v in from_flax_variables(variables).items()
          if k.startswith(prefix)}
    missing, unexpected = module.load_state_dict(sd, strict=False)
    assert not unexpected
    assert all(k.endswith("num_batches_tracked") for k in missing), missing
    return module.eval()


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _i32(v):
    return torch.tensor(np.asarray(v), dtype=torch.int32)


def _close(got, want, tol=1e-4):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=tol)


def _layers(seed):
    """A causal flax layer (BatchNorm conv, adaptive scale) with every
    variable perturbed, and the port's layer with the same weights."""
    flax_layer = FlaxLayer(size=D, attention_heads=H, ffn_units=FF,
                           dropout_rate=0.0, attention_dropout_rate=0.0,
                           cnn_module_kernel=K, cnn_norm="batch_norm",
                           causal=True)
    x = jnp.zeros((1, 8, D))
    mask = jnp.ones((1, 1, 8), bool)
    v = _perturb(flax_layer.init(jax.random.PRNGKey(seed), x, mask, x, mask),
                 seed)
    port = _load(SqueezeformerEncoderLayer(D, H, FF, K, "batch_norm", True),
                 {k: {"encoder": {"layer_0": t}} for k, t in v.items()},
                 "encoder.encoders.0.")
    return flax_layer, v, port


@pytest.mark.parametrize("rep", [1, 2], ids=["full_rate", "half_rate"])
@pytest.mark.parametrize("n_sub", [1, 2])
def test_plain_matches_pallas(rep, n_sub):
    """Four slots on a C=64 full-resolution ring, the layer at (c, C) =
    (16·n_sub, 64) / rep: cache_len (at the layer's rate) 0, 5, C/2 and
    C, write pointers 0, 10, 62 (wraps) and 34, slot 2 inactive."""
    B, C_full, c_full = 4, 64, 16 * n_sub
    C, c = C_full // rep, c_full // rep
    rs = np.random.RandomState(10 * rep + n_sub)
    _, v, port = _layers(7)
    pj = pack_sq_layer_params(v["params"], v["batch_stats"], jnp.float32)
    pj.pop("linear_pos")
    x = rs.standard_normal((B, c, D)).astype(np.float32)
    posp = rs.standard_normal((B, C + c, D)).astype(np.float32) * 0.3
    att = rs.standard_normal((B, H, C, 2 * d_k)).astype(np.float32) * 0.5
    cnn = rs.standard_normal((B, K - 1, D)).astype(np.float32) * 0.5
    clens = np.asarray([0, 5, C // 2, C], np.int32)
    y_j, att_j, cnn_j = jck.fused_chunk_layer_sq(
        jnp.asarray(x), jnp.asarray(posp), jnp.asarray(att),
        jnp.asarray(cnn), jnp.asarray(clens), pj, n_head=H, ksize=K,
        n_sub=n_sub, interpret=True)
    # the port's full-resolution ring: each layer row stored rep times
    wptr = np.asarray([0, 10, 62, 34], np.int32)
    active = np.asarray([1, 1, 0, 1], bool)
    ring = ring_from_right_aligned(np.repeat(att, rep, axis=2), wptr)
    cnn_t = _t(cnn)
    ring0, cnn0 = ring.clone(), cnn_t.clone()
    with torch.no_grad():
        y = ck.fused_chunk_layer_sq_plain(
            _t(x), _t(posp.reshape(-1, D)), _i32(np.arange(B) * (C + c)),
            ring, cnn_t, _i32(clens), _i32(wptr // rep), _i32(active),
            port.packed_params(), n_head=H, ksize=K, conv_ln=False,
            n_sub=n_sub, rep=rep)
    _close(y, y_j)
    new = right_aligned_from_ring(ring, (wptr + c_full) % C_full)
    want = np.repeat(np.asarray(att_j), rep, axis=2)
    _close(new[active], want[active])
    _close(cnn_t[active], np.asarray(cnn_j)[active])
    assert torch.equal(ring[~active], ring0[~active])
    assert torch.equal(cnn_t[~active], cnn0[~active])


def test_cached_layer_matches_flax_and_kernel_route():
    """forward_cached == the flax layer with (att_cache, cache_len) and
    cnn_cache, per-slot masks; the kernel route (plain twin on the ring
    layout) == forward_cached. Outputs and new caches, atol 1e-5."""
    B, C, c = 3, 32, 16
    rs = np.random.RandomState(6)
    flax_layer, v, layer = _layers(6)
    x = rs.standard_normal((B, c, D)).astype(np.float32)
    att = rs.standard_normal((B, H, C, 2 * d_k)).astype(np.float32) * 0.5
    cnn = rs.standard_normal((B, K - 1, D)).astype(np.float32) * 0.5
    pos = rs.standard_normal((1, C + c, D)).astype(np.float32)
    clens = [0, 7, C]
    mask = np.concatenate([np.asarray(jax_cache_key_mask(C, c, n))
                           for n in clens])
    want, att_j, cnn_j = flax_layer.apply(
        v, jnp.asarray(x), jnp.asarray(mask), jnp.asarray(pos), None,
        att_cache=(jnp.asarray(att), None), cnn_cache=jnp.asarray(cnn))
    port_mask = torch.cat([cache_key_mask(C, c, n) for n in clens])
    with torch.no_grad():
        got, att_e, cnn_e = layer.forward_cached(
            _t(x), port_mask, _t(pos), _t(att), _t(cnn))
        for a, b in ((got, want), (att_e, att_j), (cnn_e, cnn_j)):
            _close(a, b, 1e-5)
        wptr = np.asarray([4, 0, 30], np.int32)
        ring, cnn_k = ring_from_right_aligned(att, wptr), _t(cnn)
        y = ck.fused_chunk_layer_sq(
            _t(x), layer.self_attn.linear_pos(_t(pos[0])), _i32([0] * B),
            ring, cnn_k, _i32(clens), _i32(wptr), _i32([1] * B),
            layer.packed_params(), n_head=H, ksize=K, conv_ln=False)
    _close(y, got, 1e-5)
    _close(right_aligned_from_ring(ring, (wptr + c) % C), att_e, 1e-5)
    _close(cnn_k, cnn_e, 1e-5)


# --------------------------------------------------------------------------- #
# encoder
# --------------------------------------------------------------------------- #
ENC = dict(encoder_dim=D, output_size=D, attention_heads=H, num_blocks=3,
           reduce_idx=1, recover_idx=2, feed_forward_expansion_factor=2,
           cnn_module_kernel=K, causal=True, use_dynamic_chunk=True,
           time_reduction_layer_type="stream")
FEAT, WIN, CH = 80, 67, 16


@pytest.fixture(scope="module")
def encoders():
    """A streaming flax encoder with perturbed variables and the port's
    encoder carrying the same weights and statistics."""
    flax_enc = FlaxEncoder(input_size=FEAT, dropout=0.0,
                           attention_dropout_rate=0.0,
                           feed_forward_dropout_rate=0.0,
                           input_dropout_rate=0.0, **ENC)
    v = flax_enc.init({"params": jax.random.PRNGKey(0),
                       "chunk": jax.random.PRNGKey(0)},
                      jnp.zeros((1, WIN, FEAT)), jnp.asarray([WIN]),
                      decoding_chunk_size=16)
    v = _perturb(v, 0)
    port = _load(SqueezeformerEncoder(FEAT, **ENC),
                 {k: {"encoder": t} for k, t in v.items()}, "encoder.")
    return flax_enc, v, port


def _jax_chain(flax_enc, v, windows, C):
    """masr_tpu forward_chunk over windows (T, B, WIN, FEAT) → outputs per
    chunk and the final right-aligned caches."""
    st = flax_enc.apply(v, method=lambda m: m.init_cache(
        batch=windows.shape[1], cache_size=C))
    outs = []
    # one compiled step for the chain (op by op, each window retraces)
    step = jax.jit(lambda w, o, a, c, n: flax_enc.apply(
        v, w, o, a, c, n, method=FlaxEncoder.forward_chunk))
    for w in windows:
        ys, att, cnn = step(jnp.asarray(w), st["offset"], st["att_cache"],
                            st["cnn_cache"], st["cache_len"])
        st = {"att_cache": att, "cnn_cache": cnn,
              "offset": st["offset"] + CH,
              "cache_len": jnp.minimum(st["cache_len"] + CH, C)}
        outs.append(np.asarray(ys))
    return outs, st


def test_forward_chunk_chain_matches_jax(encoders):
    """Six chained chunks (the 32-row cache fills and wraps; layer 1 runs
    at half rate on its rows): outputs per chunk and the final caches, the
    half-rate layer's rows twice as masr_tpu stores them, atol 1e-5."""
    flax_enc, v, port = encoders
    C = 32
    rs = np.random.RandomState(1)
    windows = rs.standard_normal((6, 2, WIN, FEAT)).astype(np.float32)
    want, st_j = _jax_chain(flax_enc, v, windows, C)
    state = port.init_cache(batch=2, cache_size=C)
    for w, y_j in zip(windows, want):
        _close(port.forward_chunk(_t(w), state), y_j, 1e-5)
    _close(right_aligned_from_ring(state["att_cache"], state["wptr"]),
           st_j["att_cache"], 1e-5)
    _close(state["cnn_cache"], st_j["cnn_cache"], 1e-5)
    assert state["offset"].tolist() == [6 * CH] * 2
    assert state["cache_len"].tolist() == [C] * 2


@pytest.mark.parametrize("tick_k", [1, 2])
def test_forward_chunk_batched_staggered_matches_jax_chains(encoders,
                                                            tick_k):
    """Three slots that start at ticks 0, 1 and 3 and stop at different
    ticks (each slot's offset and write pointer differ), against one JAX
    forward_chunk chain per slot; tick_k = 2 runs two windows per slot per
    step (block-causal), atol 1e-5."""
    flax_enc, v, port = encoders
    C, T = 32, 6
    rs = np.random.RandomState(2)
    windows = rs.standard_normal((3, T, WIN, FEAT)).astype(np.float32)
    starts, stops = [0, 1, 3], [6, 4, 6]
    want = [_jax_chain(flax_enc, v, windows[s, :stops[s] - starts[s], None],
                       C)[0] for s in range(3)]
    state = port.init_cache(batch=3, cache_size=C)
    packed = port.pack_chunk_params(cache_size=C)
    got = [[] for _ in range(3)]
    for t in range(T):
        fed = [len(g) for g in got]
        active = np.asarray([starts[s] <= t and fed[s] + tick_k
                             <= stops[s] - starts[s] for s in range(3)])
        xs = np.zeros((3, tick_k, WIN, FEAT), np.float32)
        for s in np.flatnonzero(active):
            xs[s] = windows[s, fed[s]:fed[s] + tick_k]
        x_in = _t(xs[:, 0] if tick_k == 1 else xs)
        ys = port.forward_chunk_batched(x_in, state, packed,
                                        torch.from_numpy(active))
        for s in np.flatnonzero(active):
            got[s] += list(ys[s].reshape(tick_k, CH, D).numpy())
    for s in range(3):
        n = len(got[s])
        assert n >= 2
        _close(np.stack(got[s]), np.concatenate(want[s][:n]), 1e-5)


def test_unported_configurations_raise(encoders):
    """Pre-norm, non-rel-pos and an odd cache raise NotImplementedError,
    naming what. Non-causal chunk stepping is ported (the eager step, no
    cnn cache): four chained chunks of a non-causal encoder (`stream`
    reduction) equal masr_tpu's forward_chunk chain, outputs and att
    cache atol 1e-5; with the conv1d reduction it raises, as masr_tpu's
    forward_chunk does. Training is ported: a dynamic-chunk model's loss
    asks for its chunk generator and, given one, returns the finite loss
    dict."""
    from masr_tpu_torch.models.registry import build_model
    for conf, what in ((dict(normalize_before=True), "normalize_before"),
                       (dict(pos_enc_layer_type="abs_pos"), "abs_pos")):
        with pytest.raises(NotImplementedError, match=what):
            SqueezeformerEncoder(FEAT, **dict(ENC, **conf))
    _, _, port = encoders
    with pytest.raises(NotImplementedError, match="odd cache"):
        port.init_cache(batch=1, cache_size=31)
    flax_enc, v, _ = encoders
    flax_off = FlaxEncoder(input_size=FEAT, dropout=0.0,
                           attention_dropout_rate=0.0,
                           feed_forward_dropout_rate=0.0,
                           input_dropout_rate=0.0, **dict(ENC, causal=False))
    offline = _load(SqueezeformerEncoder(FEAT, **dict(ENC, causal=False)),
                    {k: {"encoder": t} for k, t in v.items()}, "encoder.")
    windows = np.random.RandomState(3).standard_normal(
        (4, 2, WIN, FEAT)).astype(np.float32)
    want, st_j = _jax_chain(flax_off, v, windows, 32)
    state = offline.init_cache(batch=2, cache_size=32)
    for w, y_j in zip(windows, want):
        _close(offline.forward_chunk(_t(w), state), y_j, 1e-5)
    _close(state["att_cache"], st_j["att_cache"], 1e-5)
    assert state["wptr"].tolist() == [0, 0]
    assert offline.pack_chunk_params() is None and not offline.multi_chunk
    conv1d = dict(ENC, causal=False, time_reduction_layer_type="conv1d")
    with pytest.raises(NotImplementedError, match="conv1d"):
        SqueezeformerEncoder(FEAT, **conv1d).init_cache(batch=1,
                                                        cache_size=32)
    with pytest.raises(AssertionError, match="stream"):
        _jax_chain(FlaxEncoder(input_size=FEAT, **conv1d), v, windows[:1],
                   32)
    model = build_model("squeezeformer", FEAT, 7, encoder_conf=dict(
        encoder_dim=32, output_size=32, attention_heads=2, num_blocks=2,
        cnn_module_kernel=7))
    args = (torch.zeros(1, 67, FEAT), torch.tensor([67]),
            torch.ones(1, 2, dtype=torch.long), torch.tensor([2]))
    with pytest.raises(ValueError, match="chunk_generator"):
        model(*args)
    out = model(*args, chunk_generator=torch.Generator().manual_seed(0))
    assert set(out) == {"loss", "loss_att", "loss_ctc", "acc_att"}
    assert torch.isfinite(out["loss"])
