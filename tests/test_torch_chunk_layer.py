"""The port's streaming chunk layer (masr_tpu_torch/ops/cuda/chunk_layer.py)
and chunk encoder against masr_tpu, on the CPU.

- The plain twin against the Pallas kernel `fused_chunk_layer` in
  interpret mode, over its four routes (posp, table, mirrored ring with
  inactive slots, n_sub = 2), outputs and new caches carried between the
  two cache layouts by models/weights.py: rtol = atol = 1e-4 (f32, another
  sum order).
- The port's eager cached layer against the flax layer with caches, and
  the kernel route (plain on the CPU) against the eager layer: 1e-5.
- Chained forward_chunk and staggered forward_chunk_batched against JAX
  forward_chunk chains (XLA path): 1e-5.
- fbank_torch against fbank_jax with lengths: atol 1e-3 on the log-mel.
The CUDA kernel is held against the plain twin in
tests/test_torch_cuda_kernels.py.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from masr_tpu.models.attention import cache_key_mask as jax_cache_key_mask
from masr_tpu.models.conformer import ConformerEncoder as FlaxEncoder
from masr_tpu.models.conformer import ConformerEncoderLayer as FlaxLayer
from masr_tpu.ops.pallas import chunk_layer as jck
from masr_tpu.ops.pallas.conformer_layer import pack_layer_params
from masr_tpu_torch.models.attention import cache_key_mask
from masr_tpu_torch.models.conformer import (ConformerEncoder,
                                             ConformerEncoderLayer)
from masr_tpu_torch.models.weights import (from_flax_variables,
                                           mirrored_from_ring,
                                           right_aligned_from_ring,
                                           ring_from_mirrored,
                                           ring_from_right_aligned)
from masr_tpu_torch.ops.cuda import chunk_layer as ck
from test_torch_threads import one_torch_thread  # noqa: F401

D, H, FF, K = 64, 2, 96, 7
d_k = D // H


def _flax_layer(seed):
    """A causal flax layer with every parameter perturbed → (module,
    params)."""
    layer = FlaxLayer(size=D, attention_heads=H, linear_units=FF,
                      cnn_module_kernel=K, causal=True, dropout_rate=0.0,
                      attention_dropout_rate=0.0)
    x = jnp.zeros((1, 8, D))
    mask = jnp.ones((1, 1, 8), bool)
    v = layer.init(jax.random.PRNGKey(seed), x, mask, jnp.zeros((1, 8, D)),
                   mask)
    rs = np.random.RandomState(seed)
    params = jax.tree.map(
        lambda l: np.asarray(l) + rs.standard_normal(l.shape).astype(
            np.float32) * 0.05, v["params"])
    return layer, params


def _packed(params):
    """→ (torch packed, jax packed, linear_pos (in, out) numpy)."""
    packed = pack_layer_params(params, jnp.float32)
    wpos = np.asarray(packed.pop("linear_pos"))
    return ({k: torch.from_numpy(np.array(v)) for k, v in packed.items()},
            packed, wpos)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _i32(v):
    return torch.tensor(np.asarray(v), dtype=torch.int32)


def _close(got, want, tol=1e-4):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


def _state(rs, B, C, c, scale=0.5):
    x = rs.standard_normal((B, c, D)).astype(np.float32) * 0.3
    att = rs.standard_normal((B, H, C, 2 * d_k)).astype(np.float32) * scale
    cnn = rs.standard_normal((B, K - 1, D)).astype(np.float32) * scale
    return x, att, cnn


@pytest.mark.parametrize("n_sub", [1, 2])
def test_plain_matches_pallas_posp_route(n_sub):
    """Per-slot positions, cache_len {0, partial, 16, full}, ring write
    pointers != 0 on the port's side; n_sub = 2 against JAX n_sub = 2."""
    B, C, c = 4, 64, 16 * n_sub
    rs = np.random.RandomState(n_sub)
    _, params = _flax_layer(3)
    pt, pj, _ = _packed(params)
    x, att, cnn = _state(rs, B, C, c)
    posp = rs.standard_normal((B, C + c, D)).astype(np.float32) * 0.3
    clens = np.asarray([0, 5, 16, C], np.int32)
    y_j, att_j, cnn_j = jck.fused_chunk_layer(
        jnp.asarray(x), jnp.asarray(posp), jnp.asarray(att),
        jnp.asarray(cnn), jnp.asarray(clens), pj, n_head=H, ksize=K,
        n_sub=n_sub, interpret=True)
    wptr = np.asarray([0, 9, 63, 32], np.int32)
    ring, cnn_t = ring_from_right_aligned(att, wptr), _t(cnn)
    y = ck.fused_chunk_layer_plain(
        _t(x), _t(posp.reshape(-1, D)), _i32(np.arange(B) * (C + c)), ring,
        cnn_t, _i32(clens), _i32(wptr), _i32([1] * B), pt, n_head=H,
        ksize=K, n_sub=n_sub)
    _close(y, y_j)
    _close(right_aligned_from_ring(ring, (wptr + c) % C), att_j)
    _close(cnn_t, cnn_j)


def test_plain_matches_pallas_table_route():
    """Positions from the per-layer table at per-slot offsets (c=8,
    C=32); the port's table is made from the torch linear_pos weight."""
    B, C, c, table_len = 4, 32, 8, 256
    rs = np.random.RandomState(4)
    _, params = _flax_layer(4)
    pt, pj, wpos = _packed(params)
    x, att, cnn = _state(rs, B, C, c)
    clens = np.asarray([0, 8, 24, C], np.int32)
    offsets = np.asarray([0, 8, 40, 200], np.int32)
    tab_j = jck.make_chunk_pos_table(jnp.asarray(wpos), C, table_len,
                                     jnp.float32)
    y_j, att_j, cnn_j = jck.fused_chunk_layer(
        jnp.asarray(x), None, jnp.asarray(att), jnp.asarray(cnn),
        jnp.asarray(clens), pj, None, tab_j,
        jck.clamp_pos_starts(jnp.asarray(offsets), table_len, C + c),
        n_head=H, ksize=K, interpret=True)
    tab = ck.make_chunk_pos_table(_t(wpos.T), C, table_len)
    _close(tab, np.asarray(tab_j)[:, :D])
    ring, cnn_t = _t(att), _t(cnn)
    y = ck.fused_chunk_layer_plain(
        _t(x), tab, ck.clamp_pos_starts(_i32(offsets), table_len, C + c),
        ring, cnn_t, _i32(clens), _i32([0] * B), _i32([1] * B), pt,
        n_head=H, ksize=K)
    _close(y, y_j)
    _close(right_aligned_from_ring(ring, [c] * B), att_j)
    _close(cnn_t, cnn_j)


def test_plain_matches_pallas_ring_route_with_inactive_slots():
    """Against JAX's mirrored ring over three ticks: inactive slots keep
    their att ring (JAX skips the write) and their cnn cache (the engine
    merges it), and the port leaves both untouched."""
    B, C, c, lanes = 4, 64, 16, 128
    rs = np.random.RandomState(5)
    _, params = _flax_layer(5)
    pt, pj, _ = _packed(params)
    _, att, cnn = _state(rs, B, C, c)
    ring, cnn_t = _t(att)[None], _t(cnn)
    ring_j, cnn_j = mirrored_from_ring(ring, lanes)[0], cnn
    clens = np.asarray([0, 16, 40, C], np.int32)
    wptr = np.asarray([0, 16, 48, 32], np.int32)
    for tick, active in enumerate(([1, 1, 0, 1], [0, 1, 1, 1],
                                   [1, 0, 1, 0])):
        act = np.asarray(active, bool)
        x = rs.standard_normal((B, c, D)).astype(np.float32) * 0.3
        posp = rs.standard_normal((B, C + c, D)).astype(np.float32) * 0.3
        before = ring.clone(), cnn_t.clone()
        y_j, ring_j, cnn_new = jck.fused_chunk_layer(
            jnp.asarray(x), jnp.asarray(posp), jnp.asarray(ring_j),
            jnp.asarray(cnn_j), jnp.asarray(clens), pj,
            wptrs=jnp.asarray(wptr), active=jnp.asarray(act), n_head=H,
            ksize=K, interpret=True)
        cnn_j = np.where(act[:, None, None], np.asarray(cnn_new), cnn_j)
        y = ck.fused_chunk_layer_plain(
            _t(x), _t(posp.reshape(-1, D)), _i32(np.arange(B) * (C + c)),
            ring[0], cnn_t, _i32(clens), _i32(wptr), _i32(act), pt,
            n_head=H, ksize=K)
        _close(y, y_j)
        _close(ring, ring_from_mirrored([ring_j], d_k))
        _close(cnn_t, cnn_j)
        assert torch.equal(ring[:, ~act], before[0][:, ~act]), tick
        assert torch.equal(cnn_t[~act], before[1][~act]), tick
        clens = np.where(act, np.minimum(clens + c, C), clens)
        wptr = np.where(act, (wptr + c) % C, wptr)


def _torch_layer(params):
    layer = ConformerEncoderLayer(D, H, FF, cnn_module_kernel=K, causal=True)
    sd = from_flax_variables({"params": {"encoder": {"layer_0": params}}})
    layer.load_state_dict({k[len("encoder.encoders.0."):]: v
                           for k, v in sd.items()})
    return layer.eval()


def test_cached_layer_matches_flax_and_kernel_route():
    """forward_cached == the flax layer with (att_cache, cache_len) and
    cnn_cache, per-slot masks; the kernel route (plain twin on the ring
    layout) == forward_cached. Outputs and new caches, atol 1e-5."""
    B, C, c = 3, 32, 16
    rs = np.random.RandomState(6)
    flax_layer, params = _flax_layer(6)
    x, att, cnn = _state(rs, B, C, c)
    pos = rs.standard_normal((1, C + c, D)).astype(np.float32)
    clens = [0, 7, C]
    mask = np.concatenate([np.asarray(jax_cache_key_mask(C, c, n))
                           for n in clens])
    want, att_j, cnn_j = flax_layer.apply(
        {"params": params}, jnp.asarray(x), jnp.asarray(mask),
        jnp.asarray(pos), None, att_cache=(jnp.asarray(att), None),
        cnn_cache=jnp.asarray(cnn))
    layer = _torch_layer(params)
    port_mask = torch.cat([cache_key_mask(C, c, n) for n in clens])
    with torch.no_grad():
        got, att_e, cnn_e = layer.forward_cached(
            _t(x), port_mask, _t(pos), _t(att), _t(cnn))
        np.testing.assert_array_equal(port_mask.numpy(), mask)
        for a, b in ((got, want), (att_e, att_j), (cnn_e, cnn_j)):
            _close(a, b, 1e-5)
        wptr = np.asarray([5, 0, 31], np.int32)
        ring, cnn_k = ring_from_right_aligned(att, wptr), _t(cnn)
        y = ck.fused_chunk_layer(
            _t(x), layer.self_attn.linear_pos(_t(pos[0])), _i32([0] * B),
            ring, cnn_k, _i32(clens), _i32(wptr), _i32([1] * B),
            layer.packed_params(), n_head=H, ksize=K)
    _close(y, got, 1e-5)
    _close(right_aligned_from_ring(ring, (wptr + c) % C), att_e, 1e-5)
    _close(cnn_k, cnn_e, 1e-5)


# --------------------------------------------------------------------------- #
# encoder
# --------------------------------------------------------------------------- #
ENC = dict(output_size=D, attention_heads=H, linear_units=FF, num_blocks=2,
           cnn_module_kernel=K, input_layer="conv2d",
           pos_enc_layer_type="rel_pos", normalize_before=True,
           use_cnn_module=True, activation_type="swish",
           use_dynamic_chunk=True, causal=True)
FEAT, WIN, CH = 80, 67, 16


@pytest.fixture(scope="module")
def encoders():
    """A streaming flax encoder with perturbed params and the port's
    encoder carrying the same weights."""
    flax_enc = FlaxEncoder(input_size=FEAT, dropout_rate=0.0,
                           positional_dropout_rate=0.0,
                           attention_dropout_rate=0.0, **ENC)
    xs = jnp.zeros((1, WIN, FEAT))
    v = flax_enc.init({"params": jax.random.PRNGKey(0),
                       "chunk": jax.random.PRNGKey(0)}, xs,
                      jnp.asarray([WIN]), decoding_chunk_size=16)
    rs = np.random.RandomState(0)
    params = jax.tree.map(lambda l: np.asarray(l) + 0.05 * rs.standard_normal(
        l.shape).astype(np.float32), v["params"])
    port = ConformerEncoder(FEAT, **ENC)
    sd = from_flax_variables({"params": {"encoder": params}})
    port.load_state_dict({k[len("encoder."):]: t for k, t in sd.items()})
    return flax_enc, {"params": params}, port.eval()


def _jax_chain(flax_enc, v, windows, C):
    """masr_tpu forward_chunk over windows (T, B, WIN, FEAT) → outputs
    per chunk and the final right-aligned caches."""
    st = flax_enc.apply(v, method=lambda m: m.init_cache(
        batch=windows.shape[1], cache_size=C))
    outs = []
    for w in windows:
        ys, att, cnn = flax_enc.apply(
            v, jnp.asarray(w), st["offset"], st["att_cache"],
            st["cnn_cache"], st["cache_len"],
            method=FlaxEncoder.forward_chunk)
        st = {"att_cache": att, "cnn_cache": cnn,
              "offset": st["offset"] + CH,
              "cache_len": jnp.minimum(st["cache_len"] + CH, C)}
        outs.append(np.asarray(ys))
    return outs, st


def test_forward_chunk_chain_matches_jax(encoders):
    """Six chained chunks (the 32-row cache fills and wraps): outputs per
    chunk and the final caches, atol 1e-5."""
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
    ticks, positions from the tables (each slot's offset differs), against
    one JAX forward_chunk chain per slot; tick_k = 2 runs two windows per
    slot per step (block-causal), atol 1e-5."""
    flax_enc, v, port = encoders
    C, T = 32, 6
    rs = np.random.RandomState(2)
    windows = rs.standard_normal((3, T, WIN, FEAT)).astype(np.float32)
    starts, stops = [0, 1, 3], [6, 4, 6]
    want = [_jax_chain(flax_enc, v, windows[s, :stops[s] - starts[s], None],
                       C)[0] for s in range(3)]
    state = port.init_cache(batch=3, cache_size=C)
    packed = port.pack_chunk_params(cache_size=C, pos_table_len=512)
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


def test_fbank_torch_matches_fbank_jax():
    """Batched, length-masked fbank: features and frame counts."""
    from masr_tpu.ops.fbank import fbank_jax
    from masr_tpu_torch.ops.fbank import fbank_torch
    rs = np.random.RandomState(0)
    wav = (rs.standard_normal((3, 12000)) * 3000).astype(np.float32)
    lengths = np.asarray([12000, 7001, 300], np.int32)
    wav[1, 7001:] = 0
    wav[2, 300:] = 0
    want, want_n = fbank_jax(jnp.asarray(wav), jnp.asarray(lengths))
    got, got_n = fbank_torch(_t(wav), _i32(lengths))
    np.testing.assert_array_equal(got_n.numpy(), np.asarray(want_n))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3,
                               rtol=0)
