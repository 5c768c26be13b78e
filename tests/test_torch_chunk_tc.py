"""The chunk kernels' tensor-core inputs, on the CPU: the serving
tensor-core pack and the split plan (masr_tpu_torch/ops/cuda/chunk_layer.py
`pack_chunk_tc`, `split_plan`, `chunk_plans`), which the CUDA chunk kernels
of both families (csrc/chunk_layer.cu, csrc/chunk_layer_sq.cu) read.

- The pack, for a Conformer and a Squeezeformer layer (D=64, 2 heads): each
  weight's TF32 halves add back to it within TF32's rounding of the
  remainder; the q/k/v block is [W_q | W_k | W_v]; a layer's
  chunk_packed_params() is rebuilt only after a parameter changes, and the
  plain twins read it as they read the serving pack.
- The plan: parts of a multiple of the k-tile that cover [0, K) once, a
  function of N and K alone (no M): the same plans and per-slot sums at any
  number of slots.
The kernels themselves are held against their twins, and a slot's bits at
B = 1 against its slice of a B = 32 call, in tests/test_torch_cuda_kernels.py.
"""
import inspect

import numpy as np
import pytest
import torch

from masr_tpu_torch.models.conformer import ConformerEncoderLayer
from masr_tpu_torch.models.squeezeformer import SqueezeformerEncoderLayer
from masr_tpu_torch.models.weights import seeded_state_dict
from masr_tpu_torch.ops.cuda import chunk_layer as ck
from masr_tpu_torch.ops.cuda import chunk_layer_sq as cks
from masr_tpu_torch.ops.cuda.tf32 import tf32_round
from test_torch_threads import one_torch_thread  # noqa: F401


def _layer(family, seed=5):
    if family == "conformer":
        layer = ConformerEncoderLayer(64, 2, 96, cnn_module_kernel=7,
                                      causal=True)
    else:
        layer = SqueezeformerEncoderLayer(64, 2, 128, 7, "batch_norm", True)
    layer.load_state_dict(seeded_state_dict(layer, seed=seed))
    return layer.eval()


SOURCES = {"tc_ffw1": lambda p: p["ffw1"], "tc_ffw2": lambda p: p["ffw2"],
           "tc_qkv": lambda p: torch.cat([p["attw"][0], p["attw"][1],
                                          p["attw"][2]], dim=1),
           "tc_out": lambda p: p["attw"][3], "tc_pw1": lambda p: p["pw1w"],
           "tc_pw2": lambda p: p["pw2w"]}


@pytest.mark.parametrize("family", ["conformer", "squeezeformer"])
def test_tc_pack_halves_add_back(family):
    """Every weight of the pack: big = tf32(w) bit for bit, both halves
    TF32 values (13 low mantissa bits zero), and w - (big + small) within
    TF32's rounding of the remainder w - big (2^-11 of it); the q/k/v
    block is [W_q | W_k | W_v] (D, 3D)."""
    packed = _layer(family).packed_params()
    tc = ck.pack_chunk_tc(packed)
    assert set(tc) == set(ck.TC_KEYS)
    D = packed["attw"].shape[1]
    assert tuple(tc["tc_qkv"].shape) == (2, D, 3 * D)
    for key, source in SOURCES.items():
        w = source(packed)
        big, small = tc[key].unbind(-3)
        assert tuple(big.shape) == tuple(w.shape), key
        assert torch.equal(big, tf32_round(w)), key
        for half in (big, small):
            assert torch.all(half.view(torch.int32) & 0x1FFF == 0), key
        rest = (w - big).double()
        err = (rest - small.double()).abs()
        assert torch.all(err <= 2 ** -11 * rest.abs()), key
        assert small.abs().max() > 0, key
    qkv = tc["tc_qkv"].sum(0)
    for i in range(3):
        assert torch.allclose(qkv[:, i * D:(i + 1) * D], packed["attw"][i],
                              rtol=0, atol=2 ** -20)


@pytest.mark.parametrize("family", ["conformer", "squeezeformer"])
def test_chunk_packed_params_rebuilt_only_after_a_change(family):
    """chunk_packed_params() is the serving pack plus the tensor-core pack,
    the same object until a parameter changes in place, then rebuilt from
    the new weights."""
    layer = _layer(family)
    first = layer.chunk_packed_params()
    assert layer.chunk_packed_params() is first
    packed = layer.packed_params()
    assert all(first[k] is packed[k] for k in packed)
    assert set(first) == set(packed) | set(ck.TC_KEYS)
    w1 = (layer.feed_forward.w_1 if family == "conformer"
          else layer.ffn1.w_1)
    with torch.no_grad():
        w1.weight.mul_(1.5)
    again = layer.chunk_packed_params()
    assert again is not first
    assert not torch.equal(again["tc_ffw1"], first["tc_ffw1"])
    assert torch.equal(again["tc_ffw1"], ck.pack_chunk_tc(
        layer.packed_params())["tc_ffw1"])
    assert layer.chunk_packed_params() is again


def _step_args(layer, B, c, C, ksize, seed):
    D, H = 64, 2
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(B, c, D, generator=g)
    att = 0.5 * torch.randn(B, H, C, 2 * D // H, generator=g)
    cnn = 0.5 * torch.randn(B, ksize - 1, D, generator=g)
    pos = torch.randn(B * (C + c), D, generator=g)
    starts = torch.arange(B, dtype=torch.int32) * (C + c)
    i32 = lambda v: torch.tensor(v, dtype=torch.int32)   # noqa: E731
    return (x, pos, starts, att, cnn, i32([C, 5, 0][:B]), i32([3, 0, 7][:B]),
            i32([1, 1, 0][:B]))


@pytest.mark.parametrize("family", ["conformer", "squeezeformer"])
def test_cpu_wrapper_reads_the_chunk_pack_as_the_serving_pack(family):
    """On CPU tensors the wrapper takes the plain twin, which reads only
    the serving pack's arrays: the same bits with chunk_packed_params() as
    with packed_params(), outputs and updated caches."""
    layer = _layer(family)
    fn = ck.fused_chunk_layer if family == "conformer" else \
        cks.fused_chunk_layer_sq
    kw = dict(n_head=2, ksize=7) if family == "conformer" else \
        dict(n_head=2, ksize=7, conv_ln=False)
    outs = []
    for packed in (layer.packed_params(), layer.chunk_packed_params()):
        args = _step_args(layer, 3, 8, 16, 7, seed=11)
        with torch.no_grad():
            y = fn(*args, packed, **kw)
        outs.append((y, args[3], args[4]))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


# (N, K): the flagship's products (D=256, F=2048: w_1, w_2, q/k/v, out and
# pw2, pw1), the test widths' (D=48 and 64, F=96 and 128) and edge cases
PLAN_SHAPES = [(2048, 256), (256, 2048), (768, 256), (256, 256), (512, 256),
               (96, 48), (48, 96), (144, 48), (48, 48), (128, 64), (64, 128),
               (1, 1), (1000, 33), (7, 4096), (4096, 31)]


@pytest.mark.parametrize("N,K", PLAN_SHAPES)
def test_split_plan_covers_k_in_k_tiles(N, K):
    """split_plan(N, K) = (parts, part): part a positive multiple of the
    k-tile, the parts [s·part, min((s+1)·part, K)) cover [0, K) once with
    none empty; at most one part per k-tile."""
    parts, part = ck.split_plan(N, K)
    assert parts >= 1 and part > 0 and part % ck.K_TILE == 0
    bounds = [(s * part, min((s + 1) * part, K)) for s in range(parts)]
    assert bounds[0][0] == 0 and bounds[-1][1] == K
    assert all(lo < hi for lo, hi in bounds)
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
    assert parts <= -(-K // ck.K_TILE)


def test_split_plan_takes_no_rows():
    """The plan is a function of (N, K) alone: no rows, no slot count; so
    chunk_plans gives the same plans at 1 and 32 slots and only the
    scratch grows. At the flagship's widths the narrow products (w_2, out,
    pw2) are split, and every product has ~96 blocks of 16 x 8 on one
    16-row tile (predict_stream's grid) or a part per k-tile."""
    assert list(inspect.signature(ck.split_plan).parameters) == ["N", "K"]
    one = ck.chunk_plans(1, 16, 256, 2048, 15)
    many = ck.chunk_plans(32, 16, 256, 2048, 15)
    assert one[0] == many[0] and many[1] > one[1] and many[2] > one[2]
    plans = dict(zip([n for n, _ in ck.CHUNK_PRODUCTS],
                     np.reshape(one[0], (-1, 2)).tolist()))
    assert plans["ffn_w2"][0] > 1 and plans["out"][0] > 1
    for name, nk in ck.CHUNK_PRODUCTS:
        N, K = nk(256, 2048)
        parts, part = plans[name]
        assert -(-N // 8) * parts >= 96 or part == ck.K_TILE, name


@pytest.mark.parametrize("B,c,ksize", [(1, 16, 15), (32, 16, 15),
                                       (32, 8, 31), (6, 32, 7)])
def test_chunk_plans_size_the_scratch(B, c, ksize):
    """chunk_plans' scratch holds every split product's partial sums (parts
    x rows x N floats; pw1 over the k-1+c conv-input rows) and a counter
    for each of its output tiles at the smallest (16 x 8) tile."""
    D, F_ = 256, 2048
    plans, n_partials, n_counters = ck.chunk_plans(B, c, D, F_, ksize)
    for (name, nk), (parts, part) in zip(ck.CHUNK_PRODUCTS,
                                         np.reshape(plans, (-1, 2))):
        N, K = nk(D, F_)
        assert (parts, part) == ck.split_plan(N, K)
        rows = B * (ksize - 1 + c) if name == "pw1" else B * c
        if parts > 1:
            assert parts * rows * N <= n_partials, name
            assert -(-rows // 16) * -(-N // 8) <= n_counters, name
