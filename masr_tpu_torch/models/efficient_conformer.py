"""Efficient-Conformer encoder and model: full-context and streaming
inference and training with the hybrid CTC + attention loss (port of
masr_tpu/models/efficient_conformer.py: GroupedRelPositionMultiHeadedAttention
:48-105, StridedConvolutionModule :108-160, StrideConformerEncoderLayer
:163-268, EfficientConformerEncoder :271-594 (__call__ :413-478,
_fused_tail_split :480-523, forward_chunk :531-580, init_cache :585-594),
_EffConformerLayer :597-608, EfficientConformerModel :611-635).

Progressive downsampling: the stride layers (`stride_layer_idx`) run a
conv module whose depthwise conv strides time, with an AvgPool residual
(ceil mode, padding not counted); the grouped layers (`group_layer_idx`)
attend over groups of g = group_size frames: q, k, v and the positions are
regrouped (B, h, T, d_k) → (B, h, ceil(T/g), d_k·g) in the (B, T, h, d_k)
layout, so groups interleave heads and time as upstream MASR's view does,
and the scores are divided by √(d_k·g). After a stride layer the pad mask,
the chunk mask and the positions are strided by its stride; with
`stride_kernel` each stride divides the conv kernel of the layers after it.

Routes, as masr_tpu's (`_fused_tail_split`): the layers after the last
stride or grouped layer are plain Conformer layers at the final rate (the
tail). When the conv module is layer_norm (and the shape is the kernels':
rel_pos, pre-norm, macaron, conv module, which this port requires), the
full-context encode runs the tail through the full-context layer kernel
(ops/cuda/conformer_layer.py, `forward_full_context`) and the loss path
through the training-layer kernel (ops/cuda/conformer_layer_train.py,
`forward_train`, the strided chunk mask broadcast to (B, T', T')); the
CUDA kernel on a CUDA tensor, its plain twin on a CPU tensor. The head
(grouped and stride layers) runs eagerly, with autograd in training, as
masr_tpu keeps it on XLA. A static-chunk model (static_chunk_size > 0, no
dynamic chunk) runs every layer eagerly under the strided (B, T', T')
chunk mask, the tail's attention through the flash route
(models/attention.py); a BatchNorm conv module runs every layer eagerly.

Streaming (`forward_chunk_batched`) is eager, as masr_tpu's forward_chunk:
no kernel steps this family. Its state is masr_tpu's, with a count per
slot:
  att_cache (L, B, h, C, 2·d_k)   right-aligned [K ‖ V] rows at full
                                  resolution; a layer after a stride of s
                                  reads rows s-1::s and stores its rows s
                                  times (masr_tpu's repeat)
  cnn_cache (L, B, max(k-1, 1), D) each layer's last lorder conv input rows,
                                  right-aligned (lorder = its kernel - 1)
  offset, cache_len (B,)          int32, in full-resolution frames
A chunk of c frames emits c / (product of the strides) frames. Grouped
streaming attention is only approximately full-context attention, in
masr_tpu too (its module docstring).

bf16 serving (build_model(..., dtype=torch.bfloat16), masr_tpu's
dtype=bf16), as the Conformer's (models/conformer.py): the parameters stay
f32, the features are cast to `compute_dtype` after CMVN, the eager layers
compute in their input's dtype (models/layers.py; the grouped attention's
padding, the positions and the stride layers' AvgPool residual in it, as
flax's), the tail takes row 1's bf16 mode (row 5's in a static-chunk
model), the streaming caches are bf16 and the CTC probabilities leave in
f32. Training stays f32.
"""
import torch
from torch import nn
import torch.nn.functional as F

from masr_tpu_torch.models.attention import (RelPositionMultiHeadedAttention,
                                             slot_key_mask)
from masr_tpu_torch.models.conformer import (ConformerEncoderLayer,
                                             ConformerModel,
                                             eager_chunk_step,
                                             slot_positions)
from masr_tpu_torch.models.convolution import ConvolutionModule
from masr_tpu_torch.models.layers import LayerNorm
from masr_tpu_torch.models.subsampling import subsampling_class
from masr_tpu_torch.ops.common import get_activation
from masr_tpu_torch.ops.masks import add_optional_chunk_mask, make_pad_mask

# encoder_conf keys that only steer masr_tpu's TPU routing
_IGNORED_ENCODER_KEYS = ("use_fused_layer", "use_fused_layer_train")


class GroupedRelPositionMultiHeadedAttention(RelPositionMultiHeadedAttention):
    """Rel-pos MHSA over groups of g frames; pos_bias_u / pos_bias_v are
    (h, d_k·g). It never takes the flash route (the kernel attends frame by
    frame)."""

    def __init__(self, n_head, n_feat, dropout_rate=0.0, group_size=3):
        super().__init__(n_head, n_feat, dropout_rate)
        self.group_size = group_size
        self.pos_bias_u = nn.Parameter(torch.zeros(n_head,
                                                   self.d_k * group_size))
        self.pos_bias_v = nn.Parameter(torch.zeros(n_head,
                                                   self.d_k * group_size))

    def flash_route(self, x, mask, cache=None):
        return False

    def _group(self, x):
        """(B, h, T, d) → (B, h, ceil(T/g), d·g): T padded with zero rows
        to a multiple of g, regrouped in the (B, T, h, d) layout."""
        B, h, T, d = x.shape
        x = x.transpose(1, 2)
        pad = -T % self.group_size
        if pad:
            x = F.pad(x, (0, 0, 0, 0, 0, pad))
        return x.reshape(B, -1, h, d * self.group_size).transpose(1, 2)

    def forward(self, x, mask, pos_emb, cache=None, generator=None):
        """As RelPositionMultiHeadedAttention.forward; the mask's every
        g-th row and column stand for their groups, and _attend's reshape
        of the grouped rows is the ungrouping, truncated to T rows."""
        g, T = self.group_size, x.shape[1]
        q, k, v, new_cache = self._qkv(x, cache)
        p = self._heads(self.linear_pos(pos_emb.to(x.dtype)))
        qg, kg, vg, pg = (self._group(t) for t in (q, k, v, p))
        scores = self._rel_scores(qg, kg, pg, self.pos_bias_u,
                                  self.pos_bias_v, self.d_k * g)
        out = self._attend(scores, mask[:, ::g, ::g], vg, generator)
        return out[:, :T], new_cache


class StridedConvolutionModule(ConvolutionModule):
    """The conv module with a depthwise conv of stride `stride`."""

    def __init__(self, channels, kernel_size=15, activation=F.silu,
                 norm="layer_norm", causal=False, stride=2):
        super().__init__(channels, kernel_size, activation, norm, causal,
                         stride)


def _attention(heads, size, rate, grouped, group_size):
    return GroupedRelPositionMultiHeadedAttention(
        heads, size, rate, group_size) if grouped else None


class _EffConformerLayer(ConformerEncoderLayer):
    """The Conformer layer, its attention grouped when `grouped`."""

    def __init__(self, size, attention_heads, linear_units,
                 cnn_module_kernel=15, causal=False, activation_type="swish",
                 cnn_module_norm="layer_norm", dropout_rate=0.0,
                 attention_dropout_rate=0.0, grouped=False, group_size=3):
        super().__init__(size, attention_heads, linear_units,
                         cnn_module_kernel, causal, activation_type,
                         cnn_module_norm, dropout_rate,
                         attention_dropout_rate,
                         self_attn=_attention(attention_heads, size,
                                              attention_dropout_rate,
                                              grouped, group_size))


class StrideConformerEncoderLayer(ConformerEncoderLayer):
    """The Conformer layer whose conv module strides time by `stride` and
    whose conv residual is AvgPool1d(stride, ceil_mode=True,
    count_include_pad=False). Upstream's concat_linear is never used and
    is not built."""

    def __init__(self, size, attention_heads, linear_units,
                 cnn_module_kernel=15, causal=False, activation_type="swish",
                 cnn_module_norm="layer_norm", dropout_rate=0.0,
                 attention_dropout_rate=0.0, stride=2, grouped=False,
                 group_size=3):
        super().__init__(
            size, attention_heads, linear_units, cnn_module_kernel, causal,
            activation_type, cnn_module_norm, dropout_rate,
            attention_dropout_rate,
            self_attn=_attention(attention_heads, size,
                                 attention_dropout_rate, grouped,
                                 group_size),
            conv_module=StridedConvolutionModule(
                size, cnn_module_kernel, get_activation(activation_type),
                cnn_module_norm, causal, stride))
        self.stride = stride

    def conv_residual(self, x, conv):
        """AvgPool of x's rows in groups of `stride` (the last group over
        the rows it has), cut to conv's rows, + conv."""
        B, T, C = x.shape
        s = self.stride
        pad = -T % s
        counts = torch.clamp(T - torch.arange(0, T + pad, s, device=x.device),
                             max=s).to(x.dtype)
        pooled = F.pad(x, (0, 0, 0, pad)).reshape(B, -1, s, C).sum(dim=2)
        return (pooled / counts[None, :, None])[:, :conv.shape[1]] + conv


class EfficientConformerEncoder(nn.Module):
    """CMVN → subsampling → grouped / stride / plain Conformer layers →
    after_norm."""

    # the chunk step computes its positions from the offsets, and takes one
    # window per slot: no position tables, no multi-chunk ticks
    position_tables = False
    multi_chunk = False

    def __init__(self, input_size, output_size=256, attention_heads=4,
                 linear_units=2048, num_blocks=6, dropout_rate=0.1,
                 positional_dropout_rate=0.1, attention_dropout_rate=0.0,
                 input_layer="conv2d", pos_enc_layer_type="rel_pos",
                 normalize_before=True, static_chunk_size=0,
                 use_dynamic_chunk=False, use_dynamic_left_chunk=False,
                 macaron_style=True, activation_type="swish",
                 use_cnn_module=True, cnn_module_kernel=15, causal=False,
                 cnn_module_norm="batch_norm", stride_layer_idx=(3,),
                 stride=(2,), group_layer_idx=(0, 1, 2, 3), group_size=3,
                 stride_kernel=True, efficient_conf=None, cmvn=None,
                 dtype=torch.float32, **conf):
        """Arguments as masr_tpu's EfficientConformerEncoder; efficient_conf
        (stride_layer_idx, stride, group_layer_idx, group_size,
        stride_kernel) overrides the arguments of the same names; dtype:
        the compute dtype (f32, or bf16 for serving)."""
        super().__init__()
        unknown = set(conf) - set(_IGNORED_ENCODER_KEYS)
        if unknown:
            raise TypeError(f"unknown encoder_conf keys: {sorted(unknown)}")
        for ok, what in (
                (pos_enc_layer_type == "rel_pos",
                 f"pos_enc_layer_type {pos_enc_layer_type!r}"),
                (normalize_before, "normalize_before=False"),
                (macaron_style, "macaron_style=False"),
                (use_cnn_module, "use_cnn_module=False")):
            if not ok:
                raise NotImplementedError(
                    f"{what}: the port's Conformer layers take rel_pos, "
                    "pre-norm, macaron layers with a conv module")
        eff = dict(efficient_conf or {})

        def idx_list(v):
            return [v] if isinstance(v, int) else list(v)

        self.stride_layer_idx = idx_list(eff.get("stride_layer_idx",
                                                 stride_layer_idx))
        self.strides = idx_list(eff.get("stride", stride))
        self.group_layer_idx = idx_list(eff.get("group_layer_idx",
                                                group_layer_idx))
        self.group_size = eff.get("group_size", group_size)
        kernels = [cnn_module_kernel]
        for s in self.strides:
            kernels.append(kernels[-1] // s
                           if eff.get("stride_kernel", stride_kernel)
                           else kernels[-1])
        self.kernels = kernels
        self.global_cmvn = cmvn
        self.compute_dtype = dtype
        self.output_size = output_size
        self.attention_heads = attention_heads
        self.causal = causal
        self.cnn_module_kernel = cnn_module_kernel
        self.use_dynamic_chunk = use_dynamic_chunk
        self.use_dynamic_left_chunk = use_dynamic_left_chunk
        self.static_chunk_size = static_chunk_size
        self.dropout_rate = dropout_rate
        self.attention_dropout_rate = attention_dropout_rate
        self.embed = subsampling_class(input_layer, "efficient_conformer")(
            input_size, output_size, positional_dropout_rate)
        layers, index = [], 0
        for i in range(num_blocks):
            kw = dict(cnn_module_kernel=kernels[index], causal=causal,
                      activation_type=activation_type,
                      cnn_module_norm=cnn_module_norm,
                      dropout_rate=dropout_rate,
                      attention_dropout_rate=attention_dropout_rate,
                      grouped=i in self.group_layer_idx,
                      group_size=self.group_size)
            if i in self.stride_layer_idx:
                layers.append(StrideConformerEncoderLayer(
                    output_size, attention_heads, linear_units,
                    stride=self.strides[index], **kw))
                index += 1
            else:
                layers.append(_EffConformerLayer(
                    output_size, attention_heads, linear_units, **kw))
        self.encoders = nn.ModuleList(layers)
        self.after_norm = LayerNorm(output_size, eps=1e-5)
        # the plain tail after the last stride or grouped layer takes the
        # layer kernels when its conv module is layer_norm
        special = self.stride_layer_idx + [
            i for i in self.group_layer_idx if i < num_blocks]
        start = max(special) + 1 if special else 0
        self.tail_start = start if cnn_module_norm == "layer_norm" \
            and start < num_blocks else num_blocks

    @property
    def d_k(self):
        return self.output_size // self.attention_heads

    @property
    def max_lorder(self):
        return self.cnn_module_kernel - 1 if self.causal else 0

    def downsampling_factor(self, i):
        """Product of the strides of the stride layers before layer i."""
        factor = 1
        for idx, s in zip(self.stride_layer_idx, self.strides):
            if i > idx:
                factor *= s
        return factor

    def total_factor(self):
        factor = 1
        for s in self.strides:
            factor *= s
        return factor

    def _stride_count_before(self, i):
        return sum(1 for idx in self.stride_layer_idx if i > idx)

    def _run(self, xs, masks, chunk_masks, pos_emb, tail, generator=None):
        """The head layers eagerly (every layer when tail is None), the pad
        mask, the chunk mask and the positions strided after each stride
        layer, then tail(layers, xs, chunk_masks, lens, pos_emb) over the
        layers from tail_start; after_norm → (out, masks at the final
        rate)."""
        split = self.tail_start if tail is not None else len(self.encoders)
        index = 0
        for i, layer in enumerate(self.encoders[:split]):
            xs = layer(xs, chunk_masks, pos_emb, masks, generator)
            if i in self.stride_layer_idx:
                s = self.strides[index]
                index += 1
                masks = masks[:, :, ::s]
                chunk_masks = chunk_masks[:, ::s, ::s]
                pos_emb = pos_emb[:, ::s]
        if split < len(self.encoders):
            lens = masks[:, 0, :].sum(dim=1, dtype=torch.int32)
            xs = tail(self.encoders[split:], xs, chunk_masks, lens, pos_emb)
        return self.after_norm(xs), masks

    def forward(self, xs, xs_lens):
        """Full context (masr_tpu's __call__ at decoding_chunk_size -1).
        xs: (B, T, F) f32; xs_lens: (B,) → (out (B, T', D), masks (B, 1,
        T') bool at the final rate). The tail takes the full-context layer
        kernel unless the model is static-chunk (its chunk mask kept, every
        layer eager, as masr_tpu) or its conv module BatchNorm."""
        masks = ~make_pad_mask(xs_lens, xs.shape[1])[:, None, :]
        xs, pos_emb, masks = self.embed(self._features(xs), masks)
        chunk_masks = add_optional_chunk_mask(
            xs.shape[1], masks, self.use_dynamic_chunk, False, -1,
            self.static_chunk_size, -1)

        def serve(layers, xs, chunk_masks, lens, pos_emb):
            for layer in layers:
                xs = layer.forward_full_context(xs, lens, pos_emb)
            return xs

        static = self.static_chunk_size > 0 and not self.use_dynamic_chunk
        return self._run(xs, masks, chunk_masks, pos_emb,
                         None if static else serve)

    def _features(self, xs):
        """CMVN in f32, then the compute dtype (masr_tpu casts after CMVN,
        masr_tpu/models/efficient_conformer.py:419, :540)."""
        if self.global_cmvn is not None:
            xs = self.global_cmvn(xs)
        return xs.to(self.compute_dtype)

    def forward_train(self, xs, xs_lens, generator=None,
                      chunk_generator=None):
        """The loss path (masr_tpu's __call__ with train): subsampling with
        positional dropout, the (B, T', T') chunk mask (a dynamic chunk is
        drawn from chunk_generator), the head eagerly with its dropouts
        drawn from `generator`, the tail through the training-layer kernel
        with per-(tail layer, utterance) seeds from `generator`. Dropout
        only in training mode. → (out (B, T', D), masks (B, 1, T'))."""
        if self.compute_dtype != torch.float32:
            raise NotImplementedError(
                "bf16 training (enable_amp) is not ported yet: ROADMAP "
                "queue 1, item 2")
        masks = ~make_pad_mask(xs_lens, xs.shape[1])[:, None, :]
        if self.global_cmvn is not None:
            xs = self.global_cmvn(xs)
        xs, pos_emb, masks = self.embed(xs, masks, generator=generator)
        if self.use_dynamic_chunk and chunk_generator is None:
            raise ValueError("dynamic-chunk training draws its chunk from "
                             "chunk_generator (a CPU torch.Generator)")
        chunk_masks = add_optional_chunk_mask(
            xs.shape[1], masks, self.use_dynamic_chunk,
            self.use_dynamic_left_chunk, 0, self.static_chunk_size, -1,
            generator=chunk_generator)

        def train(layers, xs, chunk_masks, lens, pos_emb):
            B, T = xs.shape[0], xs.shape[1]
            amask = chunk_masks.expand(B, T, T)
            if self.training and (self.dropout_rate > 0
                                  or self.attention_dropout_rate > 0):
                seeds = torch.randint(0, 2 ** 31 - 1, (len(layers), B),
                                      generator=generator, device=xs.device,
                                      dtype=torch.int32)
            else:
                seeds = torch.zeros(len(layers), B, dtype=torch.int32,
                                    device=xs.device)
            for j, layer in enumerate(layers):
                xs = layer.forward_train(xs, amask, seeds[j], lens, pos_emb,
                                         j)
            return xs

        return self._run(xs, masks, chunk_masks, pos_emb, train, generator)

    # ------------------------------------------------------------------ #
    # streaming
    # ------------------------------------------------------------------ #
    def init_cache(self, batch=1, cache_size=256, device=None):
        """Zeroed streaming state for `batch` slots with C = cache_size
        full-resolution cache rows per layer (the module docstring); the att
        and cnn caches in the compute dtype, as masr_tpu keeps them."""
        if cache_size < 0:
            raise ValueError(f"cache_size {cache_size}: the streaming "
                             "caches have a fixed size >= 0")

        def zeros(*shape, dtype=self.compute_dtype):
            return torch.zeros(shape, dtype=dtype, device=device)

        L = len(self.encoders)
        return {"att_cache": zeros(L, batch, self.attention_heads,
                                   cache_size, 2 * self.d_k),
                "cnn_cache": zeros(L, batch, max(self.max_lorder, 1),
                                   self.output_size),
                "offset": zeros(batch, dtype=torch.int32),
                "cache_len": zeros(batch, dtype=torch.int32)}

    def pack_chunk_params(self, cache_size=None, pos_table_len=8192):
        """No chunk kernel steps this family: nothing to pack (the engine
        hands the result back to forward_chunk_batched)."""
        return None

    def _chunk(self, xs, offsets, att_cache, cnn_cache, cache_lens):
        """masr_tpu's forward_chunk with per-slot offsets and cache lengths
        → (ys (N, c', D), new att cache, new cnn cache)."""
        cur = self.embed(self._features(xs))[0]
        C = att_cache.shape[3]
        pos_full = slot_positions(offsets, C, cur.shape[1], self.output_size)
        new_att, new_cnn = [], []
        for i, layer in enumerate(self.encoders):
            factor = self.downsampling_factor(i)
            if factor == 1:
                cache_i, pos = att_cache[i], pos_full
            else:
                # cache row j holds the frame at full position
                # offset - C + factor·j; the chunk's frames are strided
                cache_i = att_cache[i][:, :, factor - 1::factor]
                pos = torch.cat([pos_full[:, 0:C:factor],
                                 pos_full[:, C::factor]], dim=1)
            mask = slot_key_mask(cache_i.shape[2], cur.shape[1],
                                 cache_lens // factor)
            cnn_i = None
            if self.causal:
                lorder = self.kernels[self._stride_count_before(i)] - 1
                cnn_i = cnn_cache[i][:, cnn_cache.shape[2] - max(lorder, 1):]
            cur, a, c = layer.forward_cached(cur, mask, pos, cache_i, cnn_i)
            new_att.append(a.repeat_interleave(factor, dim=2)
                           if factor > 1 else a)
            new_cnn.append(cnn_cache[i] if c is None else F.pad(
                c, (0, 0, cnn_cache.shape[2] - c.shape[1], 0)))
        return (self.after_norm(cur), torch.stack(new_att),
                torch.stack(new_cnn))

    @torch.no_grad()
    def forward_chunk_batched(self, xs, state, packed=None, active=None,
                              exact_positions=False):
        """One streaming step of the `active` slots of `state` (all when
        None), eagerly, with per-slot offsets and cache lengths
        (models/conformer.py eager_chunk_step). xs: (N, T_in, F), one
        feature window per slot. packed and exact_positions are taken for
        the engine's call and unused. → (N, c', D); the active slots' state
        advances in place by c' · total_factor() full-resolution
        frames."""
        return eager_chunk_step(self._chunk, xs, state, active,
                                self.total_factor())

    def forward_chunk(self, xs, state):
        """One streaming chunk of every slot (masr_tpu's forward_chunk).
        xs: (B, T_in, F) → (B, c', D); the state advances in place."""
        return self.forward_chunk_batched(xs, state)


class EfficientConformerModel(ConformerModel):
    """Efficient-Conformer encoder + CTC head + the attention decoder
    (masr_tpu/models/efficient_conformer.py:611-635), serving and training
    with ConformerModel's hybrid loss. Streaming sets the dynamic chunk and
    the causal conv explicitly, so an encoder_conf that sets either
    raises, as in masr_tpu."""

    def make_encoder(self, input_dim, cmvn, streaming, enc_conf):
        return EfficientConformerEncoder(
            input_dim, cmvn=cmvn, use_dynamic_chunk=streaming,
            causal=streaming, **enc_conf)
