"""The port's Squeezeformer training layer (masr_tpu_torch/ops/cuda/
squeezeformer_layer_train.py) against masr_tpu, at the sizes of
tests/test_fused_sq_train.py (T'=24, D=16, FFN 32, 2 heads, conv 7, B=2,
lens 24 and 13), every parameter perturbed away from its init (biases and
the adaptive scales included), a chunk mask of 4-frame chunks with one
left chunk and padding (the last chunk of the short utterance sees no
key): the plain twin's output and its grads of x, posp and every parameter
(the adaptive scales' through their folding into the pack) against
jax.grad of the flax SqueezeformerEncoderLayer and against the Pallas
training kernel in interpret mode, causal and not, at dropout 0; and the
dropout route (determinism, the keep rate of each site, central finite
differences in f64). The CUDA kernel is held against the plain twin in
tests/test_torch_cuda_kernels.py."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from masr_tpu.models.squeezeformer import \
    SqueezeformerEncoderLayer as FlaxLayer
from masr_tpu.ops.pallas.squeezeformer_layer import \
    pack_sq_layer_params as jpack
from masr_tpu.ops.pallas.squeezeformer_layer_train import \
    fused_squeezeformer_layer_train as pallas_train
from masr_tpu_torch.models.squeezeformer import SqueezeformerEncoderLayer
from masr_tpu_torch.models.weights import (from_flax_variables,
                                           grads_to_flax_variables)
from masr_tpu_torch.ops.cuda import squeezeformer_layer_train as sqt
from masr_tpu_torch.ops.cuda.squeezeformer_layer import pack_sq_layer_params
from test_torch_threads import one_torch_thread  # noqa: F401

T, D, FF, H, K = 24, 16, 32, 2, 7
LENS = [T, 13]
PREFIX = "encoder.encoders.0."


def _mask(T, lens, chunk=4, left=1):
    """(B, T, T) bool: own chunk and `left` chunks before it, keys < len."""
    r = np.arange(T)
    rc, cc = r[:, None] // chunk, r[None, :] // chunk
    chunk_ok = (cc <= rc) & (cc >= rc - left)
    key_ok = r[None, None, :] < np.asarray(lens)[:, None, None]
    return chunk_ok[None] & key_ok


def _setup(causal, seed):
    """flax layer, its perturbed params, x, pos, the mask and pad mask."""
    flax_layer = FlaxLayer(size=D, attention_heads=H, ffn_units=FF,
                           dropout_rate=0.0, attention_dropout_rate=0.0,
                           cnn_module_kernel=K, cnn_norm="layer_norm",
                           causal=causal, adaptive_scale=True)
    rs = np.random.RandomState(seed)
    x = (0.5 * rs.standard_normal((len(LENS), T, D))).astype(np.float32)
    pos = (0.3 * rs.standard_normal((1, T, D))).astype(np.float32)
    mask = _mask(T, LENS)
    pad = np.arange(T)[None, None, :] < np.asarray(LENS)[:, None, None]
    v = flax_layer.init(jax.random.PRNGKey(seed), jnp.asarray(x),
                        jnp.asarray(mask), jnp.asarray(pos), jnp.asarray(pad))
    params = jax.tree.map(
        lambda l: np.asarray(l) + 0.1 * rs.standard_normal(l.shape).astype(
            np.float32), v["params"])
    return flax_layer, params, x, pos, mask, pad


def _torch_layer(params, causal):
    layer = SqueezeformerEncoderLayer(D, H, FF, K, "layer_norm", causal)
    sd = from_flax_variables({"params": {"encoder": {"layer_0": params}}})
    layer.load_state_dict({k[len(PREFIX):]: t for k, t in sd.items()})
    return layer


def _flax_grads(layer):
    """The port layer's parameter grads in the flax layout (the weight map
    applies the Squeezeformer's names when it sees a preln)."""
    named = {PREFIX + n: p for n, p in layer.named_parameters()}
    named["encoder.preln.weight"] = torch.zeros(D)
    got = grads_to_flax_variables(named)["params"]["encoder"]
    return got["layer_0"]


def _assert_tree(got, want, rtol, atol):
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    assert len(flat) == len(jax.tree_util.tree_leaves(got))
    for path, w in flat:
        node = got
        for k in path:
            node = node[k.key]
        np.testing.assert_allclose(node, np.asarray(w), rtol=rtol, atol=atol,
                                   err_msg=jax.tree_util.keystr(path))


def _run_plain(layer, x, pos, mask, seeds=None, rate=0.0, att_rate=0.0,
               index=0):
    """→ (y, x leaf, posp leaf): the layer packed with grad enabled, as
    forward_train packs it."""
    xt = torch.from_numpy(x).requires_grad_(True)
    posp = layer.self_attn.linear_pos(torch.from_numpy(pos)[0])
    if posp.requires_grad:
        posp.retain_grad()
    seeds = torch.zeros(len(LENS), dtype=torch.int32) if seeds is None \
        else seeds
    y = sqt.fused_squeezeformer_layer_train(
        xt, torch.from_numpy(mask), seeds,
        torch.tensor(LENS, dtype=torch.int32), posp,
        pack_sq_layer_params(layer), layer=index, n_head=H, ksize=K,
        causal=layer.causal, rate=rate, att_rate=att_rate)
    return y, xt, posp


@pytest.mark.parametrize("causal", [True, False])
def test_plain_train_layer_matches_flax_grads(causal):
    """Plain twin output == the flax layer (rtol 1e-5, atol 1e-5); grads of
    sum(sin(y)) over every row wrt x and every parameter, the adaptive
    scales and shifts of all four sublayers included, == jax.grad (rtol
    1e-4, atol 2e-5), carried into the flax layout by
    grads_to_flax_variables. The eager layer in train mode at dropout 0
    (the BatchNorm route's code) gives the same output (atol 1e-5)."""
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
    got = _flax_grads(layer)
    for sub in ("self_attn", "ffn1", "conv_module", "ffn2"):
        assert np.abs(got[sub]["ada"]["ada_scale"]).max() > 1e-3, sub
    _assert_tree(got, gp, rtol=1e-4, atol=2e-5)
    with torch.no_grad():
        eager = layer.train()(torch.from_numpy(x), torch.from_numpy(mask),
                              torch.from_numpy(pos), torch.from_numpy(pad))
    np.testing.assert_allclose(eager.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_plain_train_layer_matches_pallas_interpret(causal):
    """Plain twin == masr_tpu's Pallas training kernel (interpret mode) at
    dropout 0, both differentiated from the same flax parameters through
    their own packs: output atol 2e-5; grads of a weighted sum wrt x, posp
    and every flax parameter rtol 2e-3, atol 3e-4 (the Pallas test's own
    tolerances against its reference)."""
    _, params, x, pos, mask, _ = _setup(causal, seed=4)
    layer = _torch_layer(params, causal)
    y, xt, posp = _run_plain(layer, x, pos, mask)
    w = np.random.RandomState(9).standard_normal(y.shape).astype(np.float32)
    (y * torch.from_numpy(w)).sum().backward()
    jposp = jnp.asarray(pos[0]) @ jnp.asarray(
        params["self_attn"]["linear_pos"]["kernel"])

    def loss(p, xx, pp):
        packed = jpack(p, None, jnp.float32, adaptive_scale=True,
                       conv_ln=True)
        packed.pop("linear_pos")
        packed["posp"] = pp[None]
        out = pallas_train(xx, jnp.asarray(mask), jnp.zeros(2, jnp.int32),
                           jnp.asarray(LENS, jnp.int32), packed, H, K,
                           causal, 1e-6, 1e-5, 0.0, 0.0, True, True)
        return jnp.sum(out * w), out

    (_, want), (gp, gx, gpos) = jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True)(params, jnp.asarray(x), jposp)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want),
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), rtol=2e-3,
                               atol=3e-4)
    np.testing.assert_allclose(posp.grad.numpy(), np.asarray(gpos),
                               rtol=2e-3, atol=3e-4)
    # linear_pos is reached only through posp, which the Pallas kernel
    # takes as an input: its grad is compared through posp's above
    got = _flax_grads(layer)
    gp = jax.tree.map(np.asarray, gp)
    gp["self_attn"]["linear_pos"]["kernel"] = \
        got["self_attn"]["linear_pos"]["kernel"]
    _assert_tree(got, gp, rtol=2e-3, atol=3e-4)


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
        d = _run_plain(layer, x, pos, mask, seeds, 0.1, 0.1, index=1)[0]
        clean = _run_plain(layer, x, pos, mask)[0]
    assert torch.equal(a, b)
    assert not torch.allclose(a, c) and not torch.allclose(a, d)
    assert not torch.allclose(a, clean)


@pytest.mark.parametrize("site", range(7))
def test_dropout_keep_rate_of_each_site(site):
    """Each of the layer's seven sites, drawn as the layer draws it over
    (B=8, T'=299) rows and 256 columns at rate 0.1: the dropped fraction is
    within 5 standard deviations of 0.1, the multiplier 0 or 1/0.9, and the
    mask differs from the other sites'."""
    seeds = torch.arange(8, dtype=torch.int32) * 7919 - 3
    drop = sqt.site_dropout(seeds, 3, 299, torch.device("cpu"))
    ones = torch.ones(8, 299, 256)
    m = drop(ones, site, 0.1)
    dropped = float((m == 0).float().mean())
    assert abs(dropped - 0.1) < 5 * np.sqrt(0.1 * 0.9 / m.numel())
    assert torch.all((m == 0) | (m == torch.tensor(1 / 0.9)))
    for other in range(7):
        if other != site:
            assert not torch.equal(m, drop(ones, other, 0.1))


def test_dropout_grads_match_finite_differences():
    """At rate 0.1 / att_rate 0.1 in float64: the directional derivative
    <grad, v> of sum(sin(y)) wrt x, posp and the packed arrays equals the
    central difference along v (same masks on both sides), rtol 1e-6."""
    _, params, x, pos, mask, _ = _setup(True, seed=6)
    layer = _torch_layer(params, True).double()
    seeds = torch.tensor([3, 99], dtype=torch.int32)
    lens = torch.tensor(LENS, dtype=torch.int32)
    with torch.no_grad():
        posp = layer.self_attn.linear_pos(torch.from_numpy(pos)[0].double())
        packed = pack_sq_layer_params(layer)
    rs = np.random.RandomState(0)
    x0 = torch.from_numpy(x).double()
    vx = torch.from_numpy(rs.standard_normal(x.shape))
    vpos = torch.from_numpy(rs.standard_normal(tuple(posp.shape)))
    vp = {k: torch.from_numpy(rs.standard_normal(tuple(t.shape)))
          for k, t in packed.items()}

    def f(xx, pp, pk):
        y = sqt.fused_squeezeformer_layer_train(
            xx, torch.from_numpy(mask), seeds, lens, pp, pk, layer=2,
            n_head=H, ksize=K, causal=True, rate=0.1, att_rate=0.1)
        return torch.sin(y).sum()

    xg = x0.clone().requires_grad_(True)
    pg = posp.clone().requires_grad_(True)
    kg = {k: t.clone().requires_grad_(True) for k, t in packed.items()}
    f(xg, pg, kg).backward()
    deriv = float((xg.grad * vx).sum()) + float((pg.grad * vpos).sum()) + \
        sum(float((kg[k].grad * vp[k]).sum()) for k in kg)
    eps = 1e-6
    with torch.no_grad():
        up = f(x0 + eps * vx, posp + eps * vpos,
               {k: t + eps * vp[k] for k, t in packed.items()})
        dn = f(x0 - eps * vx, posp - eps * vpos,
               {k: t - eps * vp[k] for k, t in packed.items()})
    fd = float(up - dn) / (2 * eps)
    np.testing.assert_allclose(deriv, fd, rtol=1e-6)
