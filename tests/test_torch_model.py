"""The port's offline Conformer (masr_tpu_torch.models) against masr_tpu's
flax model: the weight map both ways, and encoder + CTC probs at the
flagship widths (configs/conformer.yml) with 2 blocks."""
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from flax.traverse_util import flatten_dict

from masr_tpu.models.cmvn import GlobalCMVN as FlaxCMVN
from masr_tpu.models.convert import convert_conformer_family
from masr_tpu.models.registry import build_model as build_flax_model
from masr_tpu_torch.models.cmvn import GlobalCMVN
from masr_tpu_torch.models.registry import build_model
from masr_tpu_torch.models.weights import (from_flax_variables,
                                           to_flax_variables)
from test_torch_threads import one_torch_thread  # noqa: F401

FLAGSHIP = dict(output_size=256, attention_heads=4, linear_units=2048,
                num_blocks=2, cnn_module_kernel=15, input_layer="conv2d",
                pos_enc_layer_type="rel_pos", normalize_before=True,
                use_cnn_module=True, activation_type="swish",
                dropout_rate=0.1, positional_dropout_rate=0.1,
                attention_dropout_rate=0.1)
DECODER = dict(attention_heads=4, linear_units=256, num_blocks=1,
               r_num_blocks=1)
VOCAB, FEAT = 4000, 80
LENS = [200, 143]


@pytest.fixture(scope="module")
def flagship():
    """Flax flagship-width model (2 blocks), every parameter perturbed
    from its init, plus CMVN stats and a (B=2) fbank-like input."""
    rs = np.random.RandomState(0)
    mean = rs.uniform(8, 14, FEAT).astype(np.float32)
    istd = rs.uniform(0.2, 0.5, FEAT).astype(np.float32)
    model = build_flax_model("conformer", FEAT, VOCAB, streaming=True,
                             encoder_conf=FLAGSHIP, decoder_conf=DECODER,
                             cmvn=FlaxCMVN(mean, istd))
    speech = (mean + rs.standard_normal((len(LENS), max(LENS), FEAT))
              * 3.0).astype(np.float32)
    lens = np.asarray(LENS, np.int32)
    v = jax.jit(functools.partial(model.init,
                                  method=type(model).get_encoder_out))(
        {"params": jax.random.PRNGKey(0)}, jnp.asarray(speech),
        jnp.asarray(lens))
    v = jax.tree.map(lambda l: np.asarray(l) + 0.02 * rs.standard_normal(
        l.shape).astype(np.float32), jax.device_get(v))
    return model, v, mean, istd, speech, lens


def test_weight_map_round_trip(flagship):
    """to_flax_variables(from_flax_variables(v)) == v exactly, decoder
    included."""
    _, v, *_ = flagship
    back = to_flax_variables(from_flax_variables(v))
    want, got = flatten_dict(v), flatten_dict(back)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=str(k))


def test_weight_map_inverts_convert(flagship):
    """masr_tpu's own converter, fed the port's state_dict, reproduces the
    flax params: the map is the exact inverse of convert.py."""
    _, v, *_ = flagship
    state = {k: t.numpy() for k, t in from_flax_variables(v).items()}
    converted, misses = convert_conformer_family(state, FEAT,
                                                 FLAGSHIP["output_size"])
    assert misses == []
    want = flatten_dict(v["params"])
    assert sorted(converted) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(converted[k], want[k], err_msg=str(k))


def test_encoder_probs_match_flax_at_flagship_width(flagship):
    """get_encoder_out probs and lens == flax ConformerModel, valid rows,
    probs atol 1e-5 and log-probs atol 5e-5 (f32 on the CPU; the port's
    layers go through the plain twin of the layer kernel)."""
    model, v, mean, istd, speech, lens = flagship
    want_p, want_l = jax.jit(functools.partial(
        model.apply, method=type(model).get_encoder_out))(
        v, jnp.asarray(speech), jnp.asarray(lens))
    port = build_model("conformer", FEAT, VOCAB, streaming=True,
                       encoder_conf=FLAGSHIP, decoder_conf=DECODER,
                       cmvn=GlobalCMVN(mean, istd))
    # v was initialised through get_encoder_out: it holds no decoder
    missing, unexpected = port.load_state_dict(from_flax_variables(v),
                                               strict=False)
    assert not unexpected and all(k.startswith("decoder.") for k in missing)
    with torch.no_grad():
        got_p, got_l = port.eval().get_encoder_out(
            torch.from_numpy(speech), torch.from_numpy(lens))
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(want_l))
    for b, n in enumerate(np.asarray(want_l)):
        got, want = got_p[b, :n].numpy(), np.asarray(want_p)[b, :n]
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
        # probs are ~1/V: the log-probs show the relative error
        np.testing.assert_allclose(np.log(got), np.log(want), atol=5e-5,
                                   rtol=0)


def test_unported_layer_shapes_raise():
    """A layer shape the kernel does not take raises, naming it."""
    for conf, what in ((dict(use_cnn_module=False), "use_cnn_module"),
                       (dict(pos_enc_layer_type="abs_pos"), "abs_pos"),
                       (dict(input_layer="conv2d6"), "conv2d6")):
        with pytest.raises(NotImplementedError, match=what):
            build_model("conformer", FEAT, 10,
                        encoder_conf=dict(output_size=32, attention_heads=2,
                                          linear_units=32, num_blocks=1,
                                          **conf))
