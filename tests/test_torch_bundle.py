"""The port's bundle reader (masr_tpu_torch/infer/flax_msgpack.py, bundle.py)
against flax.serialization, on the in-repo example bundle and on bf16 and
int8 bundles written by masr_tpu's exporter."""
import os

import numpy as np
import pytest
from flax import serialization
from flax.traverse_util import flatten_dict

from masr_tpu.infer.bundle import (_dequantize_int8, load_inference_bundle
                                   as flax_load_bundle, save_inference_bundle)
from masr_tpu_torch.infer import flax_msgpack
from masr_tpu_torch.infer.bundle import load_inference_bundle
from masr_tpu_torch.models.weights import from_flax_variables
from test_torch_threads import one_torch_thread  # noqa: F401

BUNDLE = os.path.join(os.path.dirname(__file__), "..", "examples",
                      "tiny_zh_synth", "inference_model")


def _assert_trees_equal(got, want):
    got, want = flatten_dict(got), flatten_dict(want)
    assert sorted(got) == sorted(want)
    for k in want:
        w = np.asarray(want[k])
        if w.dtype.name == "bfloat16":
            w = w.astype(np.float32)
        assert got[k].dtype == w.dtype, k
        np.testing.assert_array_equal(got[k], w, err_msg=str(k))


def _raw(path):
    with open(os.path.join(path, "model.msgpack"), "rb") as f:
        return f.read()


def test_reader_matches_flax_on_example_bundle():
    raw = _raw(BUNDLE)
    _assert_trees_equal(flax_msgpack.unpackb(raw),
                        serialization.msgpack_restore(bytearray(raw)))


@pytest.fixture(scope="module")
def quant_bundles(tmp_path_factory):
    """The example bundle re-exported by masr_tpu as bf16 and int8."""
    _, variables, meta, vocab = flax_load_bundle(BUNDLE)
    out = {}
    for quant in ("bf16", "int8"):
        d = str(tmp_path_factory.mktemp(quant))
        save_inference_bundle(
            d, meta["use_model"], meta["streaming"], meta["input_dim"],
            vocab, meta["mean"], meta["istd"], meta["encoder_conf"],
            meta["decoder_conf"], meta["model_conf"],
            meta["preprocess_conf"], variables, quant=quant)
        out[quant] = d
    return out


@pytest.mark.parametrize("quant", ["bf16", "int8"])
def test_reader_matches_flax_on_quantized_bundles(quant_bundles, quant):
    """bf16 leaves widen to the same f32 values; int8 leaves read as
    {'q': int8, 'scale': f32} exactly as flax restores them."""
    raw = _raw(quant_bundles[quant])
    _assert_trees_equal(flax_msgpack.unpackb(raw),
                        serialization.msgpack_restore(bytearray(raw)))


def test_int8_bundle_loads_dequantized_weights(quant_bundles):
    """load_inference_bundle dequantizes int8 as masr_tpu does, in the
    flax layout before the weight map: same f32 weights."""
    model, meta, _ = load_inference_bundle(quant_bundles["int8"])
    raw = _raw(quant_bundles["int8"])
    want = from_flax_variables(_dequantize_int8(
        serialization.msgpack_restore(bytearray(raw))))
    got = model.state_dict()
    for k, t in got.items():
        np.testing.assert_array_equal(t.numpy(), want[k].numpy(),
                                      err_msg=k)
    assert set(model.decoder_state) == {k for k in want
                                        if k.startswith("decoder.")}


def test_writer_round_trips_through_flax():
    """packb writes what flax.serialization restores (used to write
    seeded bundles without flax)."""
    rs = np.random.RandomState(0)
    tree = {"params": {"a": {"kernel": rs.standard_normal((3, 4)).astype(
        np.float32)}, "b": np.arange(300, dtype=np.int32),
        "c": rs.standard_normal(70000).astype(np.float32)}}
    raw = flax_msgpack.packb(tree)
    _assert_trees_equal(serialization.msgpack_restore(bytearray(raw)), tree)
    _assert_trees_equal(flax_msgpack.unpackb(raw), tree)


def test_reader_refuses_chunked_arrays():
    raw = serialization.msgpack_serialize(
        {"x": {"__msgpack_chunked_array__": True, "shape": [2]}})
    with pytest.raises(ValueError, match="chunked"):
        flax_msgpack.unpackb(raw)
