"""The port's training layer (masr_tpu_torch/ops/cuda/
conformer_layer_train.py) against masr_tpu: the plain twin's output and
autograd grads against jax.grad of the flax ConformerEncoderLayer and
against the Pallas training kernel in interpret mode (dropout 0, perturbed
biases, a dynamic-chunk mask with padding); the dropout hash against numpy;
and the dropout route on its own (determinism, keep rate, finite
differences). The CUDA kernel is held against the plain twin in
tests/test_torch_cuda_kernels.py."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from masr_tpu.models.conformer import ConformerEncoderLayer as FlaxLayer
from masr_tpu.ops.pallas.conformer_layer import pack_layer_params as jpack
from masr_tpu.ops.pallas.conformer_layer_train import \
    fused_conformer_layer_train as pallas_train
from masr_tpu_torch.models.conformer import ConformerEncoderLayer
from masr_tpu_torch.models.weights import (from_flax_variables,
                                           grads_to_flax_variables)
from masr_tpu_torch.ops import dropout_hash as dh
from masr_tpu_torch.ops.cuda import conformer_layer_train as clt
from masr_tpu_torch.ops.cuda.conformer_layer import pack_layer_params

D, H, FF, K = 32, 2, 48, 7
T = 21
LENS = [T, 13]
PREFIX = "encoder.encoders.0."


def _mask(T, lens, chunk=4):
    """(B, T, T) bool: dynamic-chunk (own chunk and earlier) & key < len."""
    r = np.arange(T)
    chunk_ok = (r[None, :] // chunk) <= (r[:, None] // chunk)
    key_ok = r[None, None, :] < np.asarray(lens)[:, None, None]
    return chunk_ok[None] & key_ok


def _setup(causal, seed):
    flax_layer = FlaxLayer(size=D, attention_heads=H, linear_units=FF,
                           cnn_module_kernel=K, causal=causal,
                           dropout_rate=0.0, attention_dropout_rate=0.0)
    rs = np.random.RandomState(seed)
    x = rs.standard_normal((len(LENS), T, D)).astype(np.float32)
    pos = rs.standard_normal((1, T, D)).astype(np.float32)
    mask = _mask(T, LENS)
    pad = np.arange(T)[None, None, :] < np.asarray(LENS)[:, None, None]
    v = flax_layer.init(jax.random.PRNGKey(seed), jnp.asarray(x),
                        jnp.asarray(mask), jnp.asarray(pos), jnp.asarray(pad))
    params = jax.tree.map(
        lambda l: np.asarray(l) + rs.standard_normal(l.shape).astype(
            np.float32) * 0.05, v["params"])
    return flax_layer, params, x, pos, mask, pad


def _torch_layer(params, causal):
    layer = ConformerEncoderLayer(D, H, FF, cnn_module_kernel=K,
                                  causal=causal)
    sd = from_flax_variables({"params": {"encoder": {"layer_0": params}}})
    layer.load_state_dict({k[len(PREFIX):]: t for k, t in sd.items()})
    return layer


def _run_plain(layer, x, pos, mask, seeds=None, rate=0.0, att_rate=0.0,
               layer_idx=0):
    """→ (y, x leaf, packed dict with retained grads)."""
    xt = torch.from_numpy(x).requires_grad_(True)
    posp = layer.self_attn.linear_pos(torch.from_numpy(pos)[0])
    packed = pack_layer_params(layer)
    for t in packed.values():
        if t.requires_grad:
            t.retain_grad()
    seeds = torch.zeros(len(LENS), dtype=torch.int32) if seeds is None \
        else seeds
    y = clt.fused_conformer_layer_train(
        xt, torch.from_numpy(mask), seeds,
        torch.tensor(LENS, dtype=torch.int32), posp, packed,
        layer=layer_idx, n_head=H, ksize=K, causal=layer.causal,
        rate=rate, att_rate=att_rate)
    return y, xt, packed


@pytest.mark.parametrize("causal", [True, False])
def test_plain_train_layer_matches_flax_grads(causal):
    """Plain twin output == flax layer (atol 1e-5); grads of sum(sin(y))
    wrt x and every parameter == jax.grad (rtol 1e-4, atol 2e-5), the
    parameter grads carried into the flax layout by
    grads_to_flax_variables."""
    flax_layer, params, x, pos, mask, pad = _setup(causal, seed=3)

    def loss(p, xx):
        y, _, _ = flax_layer.apply({"params": p}, xx, jnp.asarray(mask),
                                   jnp.asarray(pos), jnp.asarray(pad))
        return jnp.sum(jnp.sin(y)), y

    (_, want), (gp, gx) = jax.value_and_grad(loss, argnums=(0, 1),
                                             has_aux=True)(
        params, jnp.asarray(x))
    layer = _torch_layer(params, causal)
    y, xt, _ = _run_plain(layer, x, pos, mask)
    torch.sin(y).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), rtol=1e-4,
                               atol=2e-5)
    got = grads_to_flax_variables(
        {PREFIX + n: p for n, p in layer.named_parameters()})
    got = got["params"]["encoder"]["layer_0"]
    flat_want = jax.tree_util.tree_flatten_with_path(gp)[0]
    assert len(flat_want) == len(jax.tree_util.tree_leaves(got))
    for path, g in flat_want:
        node = got
        for k in path:
            node = node[k.key]
        np.testing.assert_allclose(node, np.asarray(g), rtol=1e-4, atol=2e-5,
                                   err_msg=str(path))


@pytest.mark.parametrize("causal", [True, False])
def test_plain_train_layer_matches_pallas_interpret(causal):
    """Plain twin == masr_tpu's Pallas training kernel (interpret mode) at
    dropout 0: output atol 2e-5, grads of x, posp and every packed array
    rtol 2e-3 atol 3e-4 (the Pallas test's own tolerances against its
    reference)."""
    _, params, x, pos, mask, _ = _setup(causal, seed=4)
    layer = _torch_layer(params, causal)
    y, xt, packed = _run_plain(layer, x, pos, mask)
    w = np.random.RandomState(9).standard_normal(y.shape).astype(np.float32)
    (y * torch.from_numpy(w)).sum().backward()

    jp = jpack(params, jnp.float32)
    jp["posp"] = (jnp.asarray(pos[0]) @ jp.pop("linear_pos"))[None]

    def loss(p, xx):
        out = pallas_train(xx, jnp.asarray(mask), jnp.zeros(2, jnp.int32),
                           jnp.asarray(LENS, jnp.int32), p, H, K, causal,
                           0.5, 1e-5, 0.0, 0.0, True, True)
        return jnp.sum(out * w), out

    (_, want), (gp, gx) = jax.value_and_grad(loss, argnums=(0, 1),
                                             has_aux=True)(jp, jnp.asarray(x))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want),
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), rtol=2e-3,
                               atol=3e-4)
    for k, t in packed.items():
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(gp[k]),
                                   rtol=2e-3, atol=3e-4, err_msg=k)


def _np_mix32(x):
    x = x.astype(np.uint32)
    x ^= x >> np.uint32(16)
    x *= np.uint32(0x7FEB352D)
    x ^= x >> np.uint32(15)
    x *= np.uint32(0x846CA68B)
    x ^= x >> np.uint32(16)
    return x


def test_dropout_hash_matches_numpy_uint32():
    """dropout_hash (int64 with 16-bit limbs) == the hash in numpy uint32
    wrapping arithmetic, bit for bit, negative seeds included."""
    seeds = np.asarray([0, -1, 123456789, -2 ** 31, 2 ** 31 - 1], np.int64)
    rows, cols = np.arange(37), np.arange(0, 4000, 13)
    got = dh.dropout_hash(torch.from_numpy(seeds), 11, 5,
                          torch.from_numpy(rows), torch.from_numpy(cols))
    with np.errstate(over="ignore"):
        b = np.arange(len(seeds), dtype=np.uint32)
        word = np.uint32((11 << 20) | (5 << 16)) | b
        h = _np_mix32(seeds.astype(np.uint32) ^ _np_mix32(word))
        h = _np_mix32(h[:, None] ^ rows.astype(np.uint32)[None])
        h = _np_mix32(h[:, :, None] ^ cols.astype(np.uint32)[None, None])
    np.testing.assert_array_equal(got.numpy(), h.astype(np.int64))


def test_dropout_keep_rate_and_scale():
    """Over 8 × 300 × 2048 draws at rate 0.1: the dropped fraction is within
    5 standard deviations of 0.1 and the multiplier is 0 or 1/0.9."""
    m = dh.dropout_mask(torch.arange(8, dtype=torch.int32) * 7919, 3, 0,
                        torch.arange(300), torch.arange(2048), 0.1)
    n = m.numel()
    dropped = float((m == 0).float().mean())
    assert abs(dropped - 0.1) < 5 * np.sqrt(0.1 * 0.9 / n)
    kept = m[m != 0]
    assert torch.all(kept == torch.tensor(1 / 0.9, dtype=torch.float32))


def test_dropout_route_deterministic_and_seeded():
    """At rate 0.1 / att_rate 0.1: the same seeds give the same output bits;
    other seeds, or another layer index, give another output; rate 0 gives
    the clean output."""
    _, params, x, pos, mask, _ = _setup(True, seed=5)
    layer = _torch_layer(params, True)
    seeds = torch.tensor([17, -4], dtype=torch.int32)
    with torch.no_grad():
        a = _run_plain(layer, x, pos, mask, seeds, 0.1, 0.1)[0]
        b = _run_plain(layer, x, pos, mask, seeds, 0.1, 0.1)[0]
        c = _run_plain(layer, x, pos, mask, seeds + 1, 0.1, 0.1)[0]
        d = _run_plain(layer, x, pos, mask, seeds, 0.1, 0.1, layer_idx=1)[0]
        clean = _run_plain(layer, x, pos, mask)[0]
    assert torch.equal(a, b)
    assert not torch.allclose(a, c) and not torch.allclose(a, d)
    assert not torch.allclose(a, clean)


def test_dropout_grads_match_finite_differences():
    """At rate 0.1 / att_rate 0.1 in float64: the directional derivative
    <grad, v> of sum(sin(y)) wrt x and wrt the packed weights equals the
    central difference along v (same masks on both sides), rtol 1e-6."""
    _, params, x, pos, mask, _ = _setup(True, seed=6)
    layer = _torch_layer(params, True).double()
    seeds = torch.tensor([3, 99], dtype=torch.int32)
    lens = torch.tensor(LENS, dtype=torch.int32)
    posp = layer.self_attn.linear_pos(torch.from_numpy(pos)[0].double())
    posp = posp.detach()
    packed = {k: t.detach() for k, t in pack_layer_params(layer).items()}
    rs = np.random.RandomState(0)
    x0 = torch.from_numpy(x).double()
    vx = torch.from_numpy(rs.standard_normal(x.shape))
    vp = {k: torch.from_numpy(rs.standard_normal(t.shape))
          for k, t in packed.items()}

    def f(xx, pk):
        y = clt.fused_conformer_layer_train(
            xx, torch.from_numpy(mask), seeds, lens, posp, pk, layer=2,
            n_head=H, ksize=K, causal=True, rate=0.1, att_rate=0.1)
        return torch.sin(y).sum()

    xg = x0.clone().requires_grad_(True)
    pg = {k: t.clone().requires_grad_(True) for k, t in packed.items()}
    f(xg, pg).backward()
    deriv = float((xg.grad * vx).sum()) + sum(
        float((pg[k].grad * vp[k]).sum()) for k in pg)
    eps = 1e-6
    with torch.no_grad():
        up = f(x0 + eps * vx, {k: t + eps * vp[k] for k, t in packed.items()})
        dn = f(x0 - eps * vx, {k: t - eps * vp[k] for k, t in packed.items()})
    fd = float(up - dn) / (2 * eps)
    np.testing.assert_allclose(deriv, fd, rtol=1e-6)
