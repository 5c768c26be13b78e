"""Squeezeformer encoder and model: full-context and streaming inference,
and training with the hybrid CTC + attention loss (port of
masr_tpu/models/squeezeformer.py: AdaptiveScale :28-41,
SqueezeformerAttention :44-56, SqueezeformerFFN :59-73,
SqueezeformerConvModule :76-97, TimeReductionLayer :100-127,
SqueezeformerEncoderLayer :130-202, SqueezeformerEncoder.__call__
:296-357, forward_chunk :482-536, init_cache :538-547, pack_chunk_params
:576-612, forward_chunk_batched :614-734, SqueezeformerModel :737-754).

Module names follow upstream MASR (`encoder.encoders.{i}.self_attn.ada_scale`,
`...conv_module.norm.running_mean`, `encoder.time_reduction_layer.dw_conv`),
so `models/weights.py` maps flax bundles, batch_stats included, onto them.

The layer is post-norm, x = LN_i(x + sub_i(ada_i x)) over MHSA, FFN1,
conv, FFN2 (LN eps 1e-6), with the U-Net time reduction: layers from
reduce_idx to recover_idx run at half the frame rate (the `stream` kind:
every second frame, depthwise k=1 then pointwise; `conv1d`: k=5, stride 2,
pad 3, offline only), and recover_idx repeats each frame, applies a linear
and adds the skip. Every layer runs through a layer kernel: the
full-context one (ops/cuda/squeezeformer_layer.py) offline, the chunk one
(ops/cuda/chunk_layer_sq.py) when streaming, the CUDA kernel for CUDA
tensors and its plain twin for CPU tensors. The offline encode of a
static-chunk model (which masr_tpu builds only with streaming off: with it
on, the family's chunk is dynamic) runs the eager layers instead, their
attention through the masked attention kernel
(ops/cuda/rel_pos_attention.py), as masr_tpu runs its XLA layers there.
The reduce / recover plumbing, the linear_pos products and the subsampling
stay PyTorch, as they stay XLA in masr_tpu. The eager layer module is also
the reference the tests hold the routes against.

Training (`forward_train`, the loss path of SqueezeformerModel.forward)
keeps masr_tpu's two routes (:383-404, docs/design_deviations.md #14): a
layer_norm conv module runs every layer through the training-layer kernel
(ops/cuda/squeezeformer_layer_train.py, forward and backward); the
BatchNorm default runs the eager layers, whose BatchNorm normalises with
the batch statistics and updates its running ones as flax does. Dropout
draws from the `generator` argument, the training kernel's per-(layer,
utterance) seeds included; the dynamic chunk from `chunk_generator`.

Streaming state (`init_cache`) is the Conformer's (models/conformer.py):
per-layer single-copy att rings with per-slot write pointers, updated in
place. A half-rate layer runs on the same full-resolution ring: its rows
are stored twice (rows 2p and 2p + 1), as masr_tpu stores its half-rate
cache repeated, and it reads the odd rows with cache_len / 2 and wptr / 2
(an even chunk and an even cache keep wptr even). Positions come from the
offsets at every step (masr_tpu builds no position table for this family).

A non-causal model steps its chunks eagerly (the chunk kernel takes a
causal conv), as masr_tpu's forward_chunk does, through the layers'
forward_cached with no cnn cache: its rings keep write pointer 0 (row j is
chronological row j, masr_tpu's right-aligned layout; half-rate rows
stored twice, as masr_tpu's repeat) and its cnn_cache is one unused row
per layer.

bf16 serving (build_model(..., dtype=torch.bfloat16), masr_tpu's
dtype=bf16), as the Conformer's (models/conformer.py): the parameters stay
f32; the encoder casts its features to `compute_dtype` after CMVN; the
eager modules compute in their input's dtype (models/layers.py: the
LayerNorms, the time reduction and recover, the subsampling, the
BatchNorm of the eager layers), each adaptive scale in f32 rounded to the
compute dtype, where flax's Dense rounds it; the layer kernels take their
bf16 mode (packs keyed on the dtype, the adaptive scales unfolded); the
position products are f32 sums rounded once to bf16 (masr_tpu's einsum at
preferred_element_type f32, masr_tpu/models/squeezeformer.py:421-423,
:700-702), as every bf16 Linear's (models/layers.py), whose bits do not
depend on the batch; the streaming caches are bf16; the CTC
probabilities leave in f32. bf16 training (masr_tpu's enable_amp) runs
the layer_norm route, as the Conformer's (models/conformer.py): the
training kernel's bf16 mode with the unfolded bf16 pack (its adaptive
scales' grads from the kernel), the subsampling, preln, time reduction
and recover, final_proj, the CTC head and the decoder in bf16 with
torch's differentiable products (training mode, models/layers.py). The
BatchNorm route trains in f32 only.

Not ported, each raising NotImplementedError: pre-norm layers
(normalize_before), other positional encodings than rel_pos, streaming
with an odd chunk or cache size, and more than one time reduction in force
at once while streaming. Streaming with the conv1d time reduction raises,
as in masr_tpu.
"""
import torch
import torch.nn.functional as F
from torch import nn

from masr_tpu_torch.models.attention import (RelPositionMultiHeadedAttention,
                                             slot_key_mask)
from masr_tpu_torch.models.conformer import (ConformerModel, eager_chunk_step,
                                             slot_positions)
from masr_tpu_torch.models.convolution import ConvolutionModule
from masr_tpu_torch.models.layers import (Conv1d, LayerNorm, Linear,
                                          compute_weight, half_product)
from masr_tpu_torch.models.positionwise import PositionwiseFeedForward
from masr_tpu_torch.models.subsampling import DepthwiseConv2dSubsampling4
from masr_tpu_torch.ops.common import dropout, get_activation
from masr_tpu_torch.ops.cuda.chunk_layer import pack_chunk_tc
from masr_tpu_torch.ops.cuda.chunk_layer_sq import fused_chunk_layer_sq
from masr_tpu_torch.ops.cuda.squeezeformer_layer import (
    fused_squeezeformer_layer, pack_sq_layer_params)
from masr_tpu_torch.ops.cuda.squeezeformer_layer_train import \
    fused_squeezeformer_layer_train
from masr_tpu_torch.ops.masks import add_optional_chunk_mask, make_pad_mask

# encoder_conf keys that only steer masr_tpu's TPU routing
_IGNORED_ENCODER_KEYS = ("use_fused_layer", "use_fused_layer_train")


class _AdaptiveScale:
    """Mixin: the learned per-channel scale and shift on a sublayer's input,
    x·ada_scale + ada_bias, (1, 1, D) each, in f32 and returned in x's
    dtype (flax's AdaptiveScale promotes a bf16 x to f32, and the Dense or
    the cache after it rounds to bf16); identity when disabled (the
    parameters exist either way, as in the reference)."""

    def _init_ada(self, dim, enabled):
        self.adaptive_scale = enabled
        self.ada_scale = nn.Parameter(torch.ones(1, 1, dim))
        self.ada_bias = nn.Parameter(torch.zeros(1, 1, dim))

    def ada(self, x):
        if not self.adaptive_scale:
            return x
        return (x * self.ada_scale + self.ada_bias).to(x.dtype)


class SqueezeformerAttention(RelPositionMultiHeadedAttention, _AdaptiveScale):
    """Rel-pos MHSA with the adaptive scale on the qkv input."""

    def __init__(self, n_head, n_feat, dropout_rate=0.0, adaptive_scale=True):
        super().__init__(n_head, n_feat, dropout_rate)
        self._init_ada(n_feat, adaptive_scale)

    def forward(self, x, mask, pos_emb, cache=None, generator=None):
        return super().forward(self.ada(x), mask, pos_emb, cache, generator)


class SqueezeformerFFN(PositionwiseFeedForward, _AdaptiveScale):
    """ada → w_1 → activation → w_2 (no macaron 0.5 scale)."""

    def __init__(self, idim, hidden_units, activation, dropout_rate=0.0,
                 adaptive_scale=True):
        super().__init__(idim, hidden_units, activation, dropout_rate)
        self._init_ada(idim, adaptive_scale)

    def forward(self, x, generator=None):
        return super().forward(self.ada(x), generator)


class SqueezeformerConvModule(ConvolutionModule, _AdaptiveScale):
    """ada, then the Conformer conv module (its padded rows are zeroed
    after ada; its causal cache holds post-ada rows)."""

    def __init__(self, channels, kernel_size, activation, norm, causal,
                 adaptive_scale=True):
        super().__init__(channels, kernel_size, activation, norm, causal)
        self._init_ada(channels, adaptive_scale)

    def forward(self, x, mask_pad=None, cache=None):
        return super().forward(self.ada(x), mask_pad, cache)


class TimeReductionLayer(nn.Module):
    """Halves the frame rate: `stream` (depthwise k=1, stride 2: every
    second frame) or `conv1d` (depthwise k=5, stride 2, pad 3), then a
    pointwise conv; (B, T, D) → (B, ceil(T/2), D). In bf16 (the input's)
    as flax's convs at that dtype: each product (f32 sums) rounded,
    then its bias added in that dtype; the pointwise product through
    serving_product (models/layers.py half_product) in eval mode, torch's
    differentiable product in training mode."""

    def __init__(self, channel, out_dim, kind="stream"):
        super().__init__()
        if kind not in ("stream", "conv1d"):
            raise ValueError(f"unknown time reduction {kind!r}")
        self.kind = kind
        k = 1 if kind == "stream" else 5
        self.dw_conv = Conv1d(channel, channel, k, stride=2,
                              padding=0 if kind == "stream" else 3,
                              groups=channel)
        self.pw_conv = nn.Conv1d(channel, out_dim, 1)

    def forward(self, xs, lens=None):
        """xs: (B, T, D); lens: (B,) valid frames (the rest are zeroed
        first) or None."""
        T = xs.shape[1]
        if lens is not None:
            valid = torch.arange(T, device=xs.device)[None, :] < lens[:, None]
            xs = xs.masked_fill(~valid[:, :, None], 0.0)
        half = xs.dtype == torch.bfloat16
        if self.kind == "stream":
            dw = compute_weight(self.dw_conv, xs.dtype) if half \
                else self.dw_conv.weight
            xs = xs[:, ::2] * dw[:, 0, 0] + self.dw_conv.bias.to(xs.dtype)
        else:
            xs = self.dw_conv(xs.transpose(1, 2)).transpose(1, 2)
            L = -(-T // 2)          # ceil(T/2), the strided mask's length
            xs = xs[:, :L] if xs.shape[1] >= L else nn.functional.pad(
                xs, (0, 0, 0, L - xs.shape[1]))
        if not half:
            return xs @ self.pw_conv.weight[:, :, 0].t() + self.pw_conv.bias
        y = F.linear(xs, compute_weight(self.pw_conv, xs.dtype)[:, :, 0]) \
            if self.training else half_product(xs, self.pw_conv)
        return y + self.pw_conv.bias.to(xs.dtype)


class SqueezeformerEncoderLayer(nn.Module):
    """MHSA → FFN1 → conv → FFN2, each x = LN(x + sub(ada x)) (post-norm)."""

    def __init__(self, size, attention_heads, ffn_units, cnn_module_kernel=31,
                 cnn_norm="batch_norm", causal=False, adaptive_scale=True,
                 activation_type="swish", dropout_rate=0.0,
                 attention_dropout_rate=0.0):
        super().__init__()
        act = get_activation(activation_type)
        self.size = size
        self.attention_heads = attention_heads
        self.cnn_module_kernel = cnn_module_kernel
        self.causal = causal
        self.adaptive_scale = adaptive_scale
        self.conv_ln = cnn_norm == "layer_norm"
        self.dropout_rate = dropout_rate
        self.attention_dropout_rate = attention_dropout_rate
        self.self_attn = SqueezeformerAttention(
            attention_heads, size, attention_dropout_rate, adaptive_scale)
        self.ffn1 = SqueezeformerFFN(size, ffn_units, act, dropout_rate,
                                     adaptive_scale)
        self.conv_module = SqueezeformerConvModule(
            size, cnn_module_kernel, act, cnn_norm, causal, adaptive_scale)
        self.ffn2 = SqueezeformerFFN(size, ffn_units, act, dropout_rate,
                                     adaptive_scale)
        self.layer_norm1 = LayerNorm(size, eps=1e-6)
        self.layer_norm2 = LayerNorm(size, eps=1e-6)
        self.layer_norm3 = LayerNorm(size, eps=1e-6)
        self.layer_norm4 = LayerNorm(size, eps=1e-6)
        self._packed, self._packed_key = None, None
        self._chunk_packed = None

    def forward(self, x, mask, pos_emb, mask_pad, generator=None):
        """Eager reference, and the BatchNorm route of training. x: (B, T,
        D); mask: (B, 1|T, T) bool; pos_emb: (1, T, D); mask_pad: (B, 1, T)
        bool. In training mode the dropouts (masr_tpu's sites,
        masr_tpu/models/squeezeformer.py:169-202) draw from `generator` and
        a BatchNorm conv norm normalises with the batch statistics."""
        def drop(v):
            return dropout(v, self.dropout_rate, self.training, generator)

        x = self.layer_norm1(x + drop(self.self_attn(
            x, mask, pos_emb, generator=generator)[0]))
        x = self.layer_norm2(x + drop(self.ffn1(x, generator)))
        x = self.layer_norm3(x + drop(self.conv_module(x, mask_pad)[0]))
        return self.layer_norm4(x + drop(self.ffn2(x, generator)))

    def forward_cached(self, x, mask, pos_emb, att_cache, cnn_cache):
        """Eager reference of one streaming step with masr_tpu's caches
        (as ConformerEncoderLayer.forward_cached) → (x, new att cache, new
        cnn cache)."""
        att, new_att = self.self_attn(x, mask, pos_emb, att_cache)
        x = self.layer_norm1(x + att)
        x = self.layer_norm2(x + self.ffn1(x))
        conv, new_cnn = self.conv_module(x, None, cnn_cache)
        x = self.layer_norm3(x + conv)
        return self.layer_norm4(x + self.ffn2(x)), new_att, new_cnn

    def packed_params(self, dtype=torch.float32):
        """The kernels' packed weights, in `dtype`'s layout (the compute
        dtype: pack_sq_layer_params), repacked only when a parameter or a
        BatchNorm statistic was moved or modified in place or the dtype
        changes."""
        key = (dtype,) + tuple((t.data_ptr(), t._version) for t in
                               list(self.parameters()) + list(self.buffers()))
        if key != self._packed_key:
            with torch.no_grad():
                self._packed = pack_sq_layer_params(self, dtype)
            self._packed_key = key
        return self._packed

    def chunk_packed_params(self, dtype=torch.float32):
        """packed_params(dtype) with the serving tensor-core pack of the
        chunk kernel (pack_chunk_tc), rebuilt only when packed_params()
        is."""
        packed = self.packed_params(dtype)
        if self._chunk_packed is None or self._chunk_packed[0] is not packed:
            with torch.no_grad():
                self._chunk_packed = (packed,
                                      {**packed, **pack_chunk_tc(packed)})
        return self._chunk_packed[1]

    def forward_train(self, x, mask, seeds, lens, pos_emb, index,
                      generator=None):
        """The loss path's layer. A layer_norm conv module runs the
        training-layer kernel, differentiable in x and every parameter (the
        pack is built with grad enabled, so the kernel's weight grads reach
        the parameters: in f32 the adaptive scales' through their folding,
        in bf16, x's dtype, the unfolded pack's from the kernel); mask:
        (B, T, T) bool; seeds: (B,) int32 dropout seeds of this layer;
        index: the layer's index. A BatchNorm conv module runs the eager
        layer (its batch statistics couple the utterances, as in masr_tpu,
        docs/design_deviations.md #14), its dropouts drawn from
        `generator`. Dropout only in training mode."""
        if not self.conv_ln:
            valid = torch.arange(x.shape[1], device=x.device)[None, :] \
                < lens[:, None]
            return self(x, mask, pos_emb, valid[:, None, :], generator)
        train, dtype = self.training, x.dtype
        return fused_squeezeformer_layer_train(
            x, mask, seeds, lens,
            self.self_attn.linear_pos(pos_emb[0].to(dtype)),
            pack_sq_layer_params(self, dtype), layer=index,
            n_head=self.attention_heads, ksize=self.cnn_module_kernel,
            causal=self.causal, rate=self.dropout_rate if train else 0.0,
            att_rate=self.attention_dropout_rate if train else 0.0)

    def forward_full_context(self, x, lens, pos_emb):
        """The layer through the full-context kernel, which reads the
        serving tensor-core pack (chunk_packed_params; its plain twin on a
        CPU tensor does not), in x's dtype (f32, or bf16: the kernel's bf16
        mode). lens: (B,) int32; pos_emb: (1, T, D) at the layer's rate."""
        packed = (self.chunk_packed_params(x.dtype) if x.is_cuda
                  else self.packed_params(x.dtype))
        return fused_squeezeformer_layer(
            x, lens, self.self_attn.linear_pos(pos_emb[0].to(x.dtype)),
            packed, n_head=self.attention_heads,
            ksize=self.cnn_module_kernel, causal=self.causal,
            conv_ln=self.conv_ln)


class SqueezeformerEncoder(nn.Module):
    """CMVN → DepthwiseConv2dSubsampling4 → preln → layers with the time
    reduction and recover → final_proj when output_size != encoder_dim."""

    # positions are computed from the offsets at every chunk step: no
    # position tables, so the engine needs no horizon routing
    position_tables = False

    def __init__(self, input_size, encoder_dim=256, output_size=256,
                 attention_heads=4, num_blocks=12, reduce_idx=5,
                 recover_idx=11, feed_forward_expansion_factor=8,
                 dw_stride=False, input_dropout_rate=0.1,
                 pos_enc_layer_type="rel_pos",
                 time_reduction_layer_type="conv1d",
                 feed_forward_dropout_rate=0.1, attention_dropout_rate=0.1,
                 cnn_module_kernel=31, cnn_norm_type="batch_norm",
                 dropout=0.1, causal=False, adaptive_scale=True,
                 activation_type="swish", init_weights=True,
                 normalize_before=False, use_dynamic_chunk=False,
                 static_chunk_size=0, use_dynamic_left_chunk=False,
                 cmvn=None, dtype=torch.float32, **conf):
        """Arguments as masr_tpu's SqueezeformerEncoder. dropout is the
        layers' rate (sublayer outputs and FFN hidden rows),
        attention_dropout_rate the attention probabilities',
        input_dropout_rate the subsampling's after input_proj (its
        positional encoding drops at 0.1 in training whatever the config,
        as in masr_tpu); as in masr_tpu, feed_forward_dropout_rate and
        init_weights are taken and unused. dtype: the compute dtype (f32,
        or bf16 for serving)."""
        super().__init__()
        unknown = set(conf) - set(_IGNORED_ENCODER_KEYS)
        if unknown:
            raise TypeError(f"unknown encoder_conf keys: {sorted(unknown)}")
        for ok, what in (
                (pos_enc_layer_type == "rel_pos", "pos_enc_layer_type "
                 f"{pos_enc_layer_type!r} (the kernels take rel_pos)"),
                (not normalize_before, "normalize_before=True (pre-norm; "
                 "the kernels take the post-norm layer)")):
            if not ok:
                raise NotImplementedError(
                    f"{what}: the Squeezeformer layer kernels do not take "
                    "this layer shape")

        def idx_list(r):
            return [r] if isinstance(r, int) else list(r or [])

        self.global_cmvn = cmvn
        self.compute_dtype = dtype
        self.encoder_dim = encoder_dim
        self.output_size = output_size
        self.attention_heads = attention_heads
        self.cnn_module_kernel = cnn_module_kernel
        self.causal = causal
        # a causal model's chunk kernel takes k windows per slot as one step
        self.multi_chunk = causal
        self.use_dynamic_chunk = use_dynamic_chunk
        self.use_dynamic_left_chunk = use_dynamic_left_chunk
        self.static_chunk_size = static_chunk_size
        self.dropout_rate = dropout
        self.attention_dropout_rate = attention_dropout_rate
        self.reduce_idx = idx_list(reduce_idx)
        self.recover_idx = idx_list(recover_idx)
        self.embed = DepthwiseConv2dSubsampling4(
            input_size, encoder_dim, input_dropout_rate, dw_stride=dw_stride)
        self.preln = LayerNorm(encoder_dim, eps=1e-6)
        self.encoders = nn.ModuleList(
            SqueezeformerEncoderLayer(
                encoder_dim, attention_heads,
                encoder_dim * feed_forward_expansion_factor,
                cnn_module_kernel, cnn_norm_type, causal, adaptive_scale,
                activation_type, dropout, attention_dropout_rate)
            for _ in range(num_blocks))
        self.time_reduction_layer = TimeReductionLayer(
            encoder_dim, encoder_dim,
            "stream" if time_reduction_layer_type == "stream" else "conv1d")
        self.time_recover_layer = Linear(encoder_dim, encoder_dim)
        self.final_proj = Linear(encoder_dim, output_size) \
            if output_size != encoder_dim else None

    def downsampling_factor(self, i):
        """The frame-rate divisor at layer i (masr_tpu's, encoder.py:226)."""
        reduce_exp = sum(1 for idx in self.reduce_idx if i >= idx)
        recover_exp = sum(1 for idx in self.recover_idx if i >= idx)
        return 2 ** max(reduce_exp - recover_exp, 0)

    def _layers(self, xs, ctx, lens, reduce, run):
        """The layer stack with the U-Net steps, as masr_tpu walks it
        (masr_tpu/models/squeezeformer.py:327-354): at a reduce index the
        current (xs, ctx, lens) is saved and `reduce` gives the half-rate
        ones (ctx: what the layers take at the current rate, positions or
        positions and mask); at a recover index the saved entry is restored
        and xs is repeated, projected and added to its rows;
        `run(i, layer, xs, ctx, lens)` runs layer i."""
        saved, index = [], 0
        for i, layer in enumerate(self.encoders):
            if i in self.reduce_idx:
                saved.append((xs, ctx, lens))
                xs, ctx, lens = reduce(xs, ctx, lens)
                index += 1
            if i in self.recover_idx:
                index -= 1
                r_xs, ctx, lens = saved[index]
                up = self.time_recover_layer(xs.repeat_interleave(2, dim=1))
                xs = r_xs + up[:, :r_xs.shape[1]]
            xs = run(i, layer, xs, ctx, lens)
        return self.final_proj(xs) if self.final_proj is not None else xs

    def _reduce_masked(self, xs, ctx, lens):
        """The time reduction under a (B, T, T) mask: the rows within each
        length reduced, ctx = (positions, mask) strided to [:, ::2] and
        [:, ::2, ::2], the lengths halved rounding up (masr_tpu's
        :327-336)."""
        pos, mask = ctx
        return (self.time_reduction_layer(xs, lens),
                (pos[:, ::2], mask[:, ::2, ::2]), (lens + 1) // 2)

    def forward(self, xs, xs_lens):
        """Full context (masr_tpu's __call__ at decoding_chunk_size -1).
        xs: (B, T, F) f32; xs_lens: (B,) → (out (B, T', output_size), masks
        (B, 1, T') bool). A static-chunk model (static_chunk_size > 0, no
        dynamic chunk) keeps its block mask, as masr_tpu: the eager layers
        (eval mode: BatchNorm on its running statistics) under
        add_optional_chunk_mask's (B, T', T') mask and a pad mask from the
        lengths, their attention through the flash route; every other model
        runs each layer through the full-context layer kernel."""
        masks = ~make_pad_mask(xs_lens, xs.shape[1])[:, None, :]
        xs, pos_emb, masks = self.embed(self._features(xs), masks)
        lens = masks[:, 0, :].sum(dim=1, dtype=torch.int32)
        if self.static_chunk_size > 0 and not self.use_dynamic_chunk:
            chunk_masks = add_optional_chunk_mask(
                xs.shape[1], masks, False, False, -1, self.static_chunk_size,
                -1)

            def run(i, layer, xs, ctx, lens):
                pad = torch.arange(xs.shape[1], device=xs.device)[None, :] \
                    < lens[:, None]
                return layer(xs, ctx[1], ctx[0], pad[:, None, :])

            out = self._layers(self.preln(xs), (pos_emb, chunk_masks), lens,
                               self._reduce_masked, run)
            return out, masks

        def reduce(xs, pos, lens):
            return (self.time_reduction_layer(xs, lens), pos[:, ::2],
                    (lens + 1) // 2)

        out = self._layers(
            self.preln(xs), pos_emb, lens, reduce,
            lambda i, layer, xs, pos, lens: layer.forward_full_context(
                xs, lens, pos))
        return out, masks

    def _features(self, xs):
        """CMVN in f32, then the compute dtype (masr_tpu casts after CMVN,
        masr_tpu/models/squeezeformer.py:302, :492, :644)."""
        if self.global_cmvn is not None:
            xs = self.global_cmvn(xs)
        return xs.to(self.compute_dtype)

    def forward_train(self, xs, xs_lens, generator=None,
                      chunk_generator=None):
        """The loss path (masr_tpu's __call__ with train, :296-357):
        subsampling with positional dropout, the (B, T', T') chunk mask (a
        dynamic chunk is drawn from chunk_generator), every layer through
        forward_train with per-(layer, utterance) seeds from `generator`.
        At the reduce index the time reduction runs on the rows within
        each length and the layers after it take chunk_masks[:, ::2, ::2],
        pos_emb[:, ::2] and the lengths halved rounding up; the recover
        index restores them. In the compute dtype after CMVN (bf16: the
        layer_norm route only). Dropout only in training mode. → (out (B,
        T', output_size), masks (B, 1, T'))."""
        if self.compute_dtype != torch.float32 and not all(
                layer.conv_ln for layer in self.encoders):
            raise NotImplementedError(
                "bf16 training (enable_amp) of a BatchNorm conv module is "
                "not ported: ROADMAP queue 1, item 2")
        masks = ~make_pad_mask(xs_lens, xs.shape[1])[:, None, :]
        xs, pos_emb, masks = self.embed(self._features(xs), masks,
                                        generator=generator)
        B, T2 = xs.shape[0], xs.shape[1]
        if self.use_dynamic_chunk and chunk_generator is None:
            raise ValueError("dynamic-chunk training draws its chunk from "
                             "chunk_generator (a CPU torch.Generator)")
        chunk_masks = add_optional_chunk_mask(
            T2, masks, self.use_dynamic_chunk, self.use_dynamic_left_chunk,
            0, self.static_chunk_size, -1, generator=chunk_generator)
        lens = masks[:, 0, :].sum(dim=1, dtype=torch.int32)
        if self.training and (self.dropout_rate > 0
                              or self.attention_dropout_rate > 0):
            seeds = torch.randint(0, 2 ** 31 - 1, (len(self.encoders), B),
                                  generator=generator, device=xs.device,
                                  dtype=torch.int32)
        else:
            seeds = torch.zeros(len(self.encoders), B, dtype=torch.int32,
                                device=xs.device)

        def run(i, layer, xs, ctx, lens):
            return layer.forward_train(xs, ctx[1], seeds[i], lens, ctx[0], i,
                                       generator)

        out = self._layers(self.preln(xs), (pos_emb, chunk_masks), lens,
                           self._reduce_masked, run)
        return out, masks

    # ------------------------------------------------------------------ #
    # streaming
    # ------------------------------------------------------------------ #
    def _check_streaming(self, cache_size):
        if self.reduce_idx and self.time_reduction_layer.kind != "stream":
            raise NotImplementedError(
                "streaming with the conv1d time reduction: masr_tpu streams "
                "with the 'stream' kind only")
        if any(self.downsampling_factor(i) > 2
               for i in range(len(self.encoders))):
            raise NotImplementedError(
                "streaming with two time reductions in force at once")
        if cache_size % 2:
            raise NotImplementedError(
                f"an odd cache size {cache_size}: half-rate layers keep "
                "every second cache row")

    def init_cache(self, batch=1, cache_size=256, device=None):
        """Zeroed streaming state for `batch` slots with C = cache_size
        cache rows per layer (the layout of the module docstring); the att
        and cnn caches in the compute dtype, as masr_tpu keeps them."""
        if cache_size < 0:
            raise ValueError(f"cache_size {cache_size}: the streaming "
                             "caches have a fixed size >= 0")
        self._check_streaming(cache_size)
        L = len(self.encoders)
        d_k = self.encoder_dim // self.attention_heads

        def zeros(*shape, dtype=self.compute_dtype):
            return torch.zeros(shape, dtype=dtype, device=device)

        return {"att_cache": zeros(L, batch, self.attention_heads,
                                   cache_size, 2 * d_k),
                "cnn_cache": zeros(L, batch, self.cnn_module_kernel - 1
                                   if self.causal else 1, self.encoder_dim),
                "offset": zeros(batch, dtype=torch.int32),
                "cache_len": zeros(batch, dtype=torch.int32),
                "wptr": zeros(batch, dtype=torch.int32)}

    def pack_chunk_params(self, cache_size=None, pos_table_len=8192):
        """Per layer: the kernel weights (BatchNorm folded) with the serving
        tensor-core pack (chunk_packed_params), in the compute dtype's
        layout. cache_size and
        pos_table_len are taken for the engine's call and unused: the
        positions come from the offsets at every step. A non-causal model,
        which steps eagerly, packs nothing (None)."""
        if not self.causal:
            return None
        return [layer.chunk_packed_params(self.compute_dtype)
                for layer in self.encoders]

    @torch.no_grad()
    def forward_chunk_batched(self, xs, state, packed=None, active=None,
                              exact_positions=False):
        """One streaming step of every slot of `state` through the chunk
        kernel, with per-slot offsets and cache validity, each layer at its
        rate (half-rate layers at (c/2, C/2) on the shared ring).

        xs: (N, T_in, F) one feature window per slot, T_in = (c-1)·4 + 7;
        or (N, k, T_in, F), k windows per slot run as ONE multi-chunk step
        (block-causal over the k sub-chunks, equal to k single steps).
        packed: pack_chunk_params(). active: (N,) bool or None (all); the
        caches and counters of inactive slots stay untouched.
        exact_positions: taken for the engine's call; positions are always
        exact here. → (N, c·k, output_size); the state advances in
        place. A non-causal model takes the eager step (_chunk_eager), one
        window per slot."""
        if not self.causal:
            self._check_streaming(state["att_cache"].shape[3])
            return eager_chunk_step(self._chunk_eager, xs, state, active)
        n_sub = 1
        if xs.dim() == 4:
            n_sub = xs.shape[1]
            xs = xs.reshape((-1,) + tuple(xs.shape[2:]))
        # each window subsamples on its own, as sequential steps feed them
        xs = self.embed(self._features(xs))[0]
        if n_sub > 1:
            xs = xs.reshape(xs.shape[0] // n_sub, -1, xs.shape[2])
        N, chunk = xs.shape[0], xs.shape[1]
        att, cnn = state["att_cache"], state["cnn_cache"]
        C, dev = att.shape[3], xs.device
        self._check_streaming(C)
        if self.reduce_idx and (chunk // n_sub) % 2:
            raise NotImplementedError(
                f"an odd chunk of {chunk // n_sub} frames: the time "
                "reduction keeps every second frame of each chunk")
        if packed is None:
            packed = self.pack_chunk_params()
        if active is None:
            active = torch.ones(N, dtype=torch.bool, device=dev)
        act_i32 = active.to(dev, torch.bool).to(torch.int32)
        L = C + chunk
        pe = slot_positions(state["offset"], C, chunk, self.encoder_dim)
        # half-rate keys: cache row j holds the half-frame at full position
        # row 2j, then the strided chunk (masr_tpu's pos_half)
        pe_half = torch.cat([pe[:, 0:C:2], pe[:, C::2]], dim=1)
        step = {1: (pe.reshape(-1, self.encoder_dim), L, state["cache_len"],
                    state["wptr"]),
                2: (pe_half.reshape(-1, self.encoder_dim), pe_half.shape[1],
                    state["cache_len"] // 2, state["wptr"] // 2)}

        def reduce(xs, pos, lens):
            return self.time_reduction_layer(xs), pos, lens

        def run(i, layer, xs, pos, lens):
            rate = self.downsampling_factor(i)
            pos_rows, rows_per_slot, clens, wptrs = step[rate]
            return fused_chunk_layer_sq(
                xs, layer.self_attn.linear_pos(pos_rows.to(xs.dtype)),
                torch.arange(N, dtype=torch.int32, device=dev)
                * rows_per_slot, att[i], cnn[i], clens, wptrs, act_i32,
                packed[i], n_head=layer.attention_heads,
                ksize=layer.cnn_module_kernel, conv_ln=layer.conv_ln,
                n_sub=n_sub, rep=rate)

        out = self._layers(self.preln(xs), None, None, reduce, run)
        adv = act_i32 * chunk
        state["offset"].add_(adv)
        state["cache_len"].copy_(torch.clamp(state["cache_len"] + adv,
                                             max=C))
        if C:
            state["wptr"].copy_((state["wptr"] + adv) % C)
        return out

    def _chunk_eager(self, xs, offsets, att_cache, cnn_cache, cache_lens):
        """masr_tpu's forward_chunk of a non-causal model (every conv
        within the chunk, no cnn cache), per-slot offsets and cache lengths
        → (ys (N, c, output_size), new right-aligned att cache, cnn_cache
        as it was). A half-rate layer reads the odd cache rows with half
        the valid count and stores its rows twice."""
        cur = self.embed(self._features(xs))[0]
        C, chunk = att_cache.shape[3], cur.shape[1]
        if self.reduce_idx and chunk % 2:
            raise NotImplementedError(
                f"an odd chunk of {chunk} frames: the time reduction keeps "
                "every second frame of each chunk")
        pos = slot_positions(offsets, C, chunk, self.encoder_dim)
        # half-rate keys: cache row j holds the half-frame at full position
        # row 2j, then the strided chunk (masr_tpu's pos_half)
        rates = {1: (att_cache, pos, cache_lens),
                 2: (att_cache[:, :, :, 1::2],
                     torch.cat([pos[:, 0:C:2], pos[:, C::2]], dim=1),
                     cache_lens // 2)}
        new_att = [None] * len(self.encoders)

        def reduce(xs, ctx, lens):
            return self.time_reduction_layer(xs), ctx, lens

        def run(i, layer, xs, ctx, lens):
            rate = self.downsampling_factor(i)
            caches, p, clens = rates[rate]
            xs, a, _ = layer.forward_cached(
                xs, slot_key_mask(caches.shape[3], xs.shape[1], clens), p,
                caches[i], None)
            new_att[i] = a.repeat_interleave(rate, dim=2)
            return xs

        out = self._layers(self.preln(cur), None, None, reduce, run)
        return out, torch.stack(new_att), cnn_cache

    def forward_chunk(self, xs, state):
        """One streaming chunk of every slot (masr_tpu's forward_chunk),
        all slots active. xs: (B, T_in, F) → (B, c, output_size); the state
        advances in place."""
        return self.forward_chunk_batched(xs, state)


class SqueezeformerModel(ConformerModel):
    """Squeezeformer encoder + CTC head + the attention decoder
    (masr_tpu/models/squeezeformer.py:737-754): serving, and training with
    ConformerModel's hybrid loss (`forward`). Streaming gives causal convs
    and the `stream` time reduction."""

    def make_encoder(self, input_dim, cmvn, streaming, enc_conf):
        return SqueezeformerEncoder(
            input_dim, cmvn=cmvn, use_dynamic_chunk=streaming,
            causal=streaming,
            time_reduction_layer_type="stream" if streaming else "conv1d",
            **enc_conf)
