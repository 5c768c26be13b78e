"""The port's full-context Conformer layer (masr_tpu_torch/ops/cuda/
conformer_layer.py) against masr_tpu: the plain twin against the Pallas
kernel in interpret mode, and the port's eager layer module against the
flax layer. The CUDA kernel is held against the plain twin in
tests/test_torch_cuda_kernels.py."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from masr_tpu.models.conformer import ConformerEncoderLayer as FlaxLayer
from masr_tpu.ops.pallas.conformer_layer import (fused_conformer_layer,
                                                 pack_layer_params)
from masr_tpu_torch.models.conformer import ConformerEncoderLayer
from masr_tpu_torch.models.weights import from_flax_variables
from masr_tpu_torch.ops.cuda import conformer_layer as cl
from test_torch_threads import one_torch_thread  # noqa: F401

D, H, FF, K = 64, 2, 96, 7
T = 45                                   # not a multiple of 16
LENS = [T, T - 9, 0]


def _flax_layer(causal, seed):
    """A flax layer with every parameter perturbed (fresh-init zero biases
    once hid a conv padding bug) → (module, params, x, pos_emb)."""
    layer = FlaxLayer(size=D, attention_heads=H, linear_units=FF,
                      cnn_module_kernel=K, causal=causal, dropout_rate=0.0,
                      attention_dropout_rate=0.0)
    rs = np.random.RandomState(seed)
    x = rs.standard_normal((len(LENS), T, D)).astype(np.float32)
    pos = rs.standard_normal((1, T, D)).astype(np.float32)
    mask = np.arange(T)[None, None, :] < np.asarray(LENS)[:, None, None]
    v = layer.init(jax.random.PRNGKey(seed), jnp.asarray(x),
                   jnp.asarray(mask), jnp.asarray(pos), jnp.asarray(mask))
    params = jax.tree.map(
        lambda l: np.asarray(l) + rs.standard_normal(l.shape).astype(
            np.float32) * 0.05, v["params"])
    return layer, params, x, pos, mask


def _valid(out):
    return np.concatenate([np.asarray(out)[b, :n] for b, n in
                           enumerate(LENS)])


def _packed_torch(params):
    packed = pack_layer_params(params, jnp.float32)
    linear_pos = np.asarray(packed.pop("linear_pos"))
    return ({k: torch.from_numpy(np.array(v)) for k, v in packed.items()},
            {k: v for k, v in packed.items()}, linear_pos)


@pytest.mark.parametrize("causal", [True, False])
def test_plain_layer_matches_pallas_interpret(causal):
    """fused_conformer_layer_plain == the JAX Pallas kernel (interpret
    mode) on valid rows, rtol = atol = 1e-4 (f32, different sum order)."""
    _, params, x, pos, _ = _flax_layer(causal, seed=11)
    packed_t, packed_j, linear_pos = _packed_torch(params)
    pos_p = pos[0] @ linear_pos
    lens = np.asarray(LENS, np.int32)
    want = fused_conformer_layer(
        jnp.asarray(x), jnp.asarray(lens), jnp.asarray(pos_p), packed_j,
        n_head=H, ksize=K, causal=causal, interpret=True)
    got = cl.fused_conformer_layer_plain(
        torch.from_numpy(x), torch.from_numpy(lens), torch.from_numpy(pos_p),
        packed_t, n_head=H, ksize=K, causal=causal)
    np.testing.assert_allclose(_valid(got), _valid(want), rtol=1e-4,
                               atol=1e-4)
    assert np.isfinite(got.numpy()).all()


def _torch_layer(params, causal):
    layer = ConformerEncoderLayer(D, H, FF, cnn_module_kernel=K,
                                  causal=causal)
    sd = from_flax_variables({"params": {"encoder": {"layer_0": params}}})
    layer.load_state_dict({k[len("encoder.encoders.0."):]: v
                           for k, v in sd.items()})
    return layer.eval()


@pytest.mark.parametrize("causal", [True, False])
def test_layer_module_matches_flax(causal):
    """The port's eager ConformerEncoderLayer (weights carried by
    from_flax_variables) == the flax layer, valid rows, atol 1e-5."""
    flax_layer, params, x, pos, mask = _flax_layer(causal, seed=5)
    want, _, _ = flax_layer.apply({"params": params}, jnp.asarray(x),
                                  jnp.asarray(mask), jnp.asarray(pos),
                                  jnp.asarray(mask))
    layer = _torch_layer(params, causal)
    with torch.no_grad():
        got = layer(torch.from_numpy(x), torch.from_numpy(mask),
                    torch.from_numpy(pos), torch.from_numpy(mask))
    np.testing.assert_allclose(_valid(got), _valid(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_packed_route_matches_layer_module(causal):
    """The kernel route (pack_layer_params of the port's module +
    fused_conformer_layer, plain on the CPU) == the eager module, atol
    1e-5; the CPU call launches nothing."""
    _, params, x, pos, mask = _flax_layer(causal, seed=7)
    layer = _torch_layer(params, causal)
    lens = torch.tensor(LENS, dtype=torch.int32)
    before = cl.fused_conformer_layer.launches
    with torch.no_grad():
        pos_p = layer.self_attn.linear_pos(torch.from_numpy(pos)[0])
        got = cl.fused_conformer_layer(
            torch.from_numpy(x), lens, pos_p, cl.pack_layer_params(layer),
            n_head=H, ksize=K, causal=causal)
        want = layer(torch.from_numpy(x), torch.from_numpy(mask),
                     torch.from_numpy(pos), torch.from_numpy(mask))
    assert cl.fused_conformer_layer.launches == before
    np.testing.assert_allclose(_valid(got), _valid(want), rtol=1e-5,
                               atol=1e-5)

