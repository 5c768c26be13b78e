"""Conformer encoder and model: full-context and streaming inference and
training with the hybrid CTC + attention loss (port of
masr_tpu/models/conformer.py: ConformerEncoderLayer.__call__ :92-133,
ConformerEncoder.__call__ :235-273, forward_chunk :353-395,
forward_chunk_batched :417-561, pack_chunk_params :563-586, init_cache
:588-621, ConformerModel.__call__ :686-736, get_encoder_out :738-749,
get_encoder_out_chunk :751-763, get_encoder_out_chunk_batched :789-836,
get_encoder_out_chunk_full :838, encode_for_rescoring :860,
_gather_hyp_scores :870, rescore_hyps :877).

Module names follow upstream MASR (`encoder.encoders.{i}.self_attn...`,
`ctc.ctc_lo`, `decoder.left_decoder...`), so `models/weights.py` maps flax
bundles and upstream checkpoints onto them.

Routes. The encoder decides once, at construction, whether its layer shape
is the layer kernels' (`layer_route`, kernel_layer_shape: masr_tpu's
fused-route terms, masr_tpu/models/conformer.py:287-320, and the swish
activation, the one the kernels compute). On "kernel" it runs every layer
through a layer kernel: the full-context one (ops/cuda/conformer_layer.py)
offline, the chunk one (ops/cuda/chunk_layer.py) when streaming a causal
model, and the training one (ops/cuda/conformer_layer_train.py, forward
and backward) in `forward_train`, the loss path; the CUDA kernel for CUDA
tensors, its plain twin for CPU tensors. The offline encode of a
static-chunk model runs the eager layer module below instead, as masr_tpu
runs its XLA layers there, and their attention takes the masked attention
kernel (ops/cuda/rel_pos_attention.py, models/attention.py's flash route).
On "eager" (another positional encoding, post-norm, no macaron, no conv
module, a BatchNorm conv module, an activation other than swish) every
route runs the eager layers on the tensors' own device, as masr_tpu keeps
these shapes on XLA: offline under the full mask (their rel-pos attention
through the flash route where its rule holds), training under autograd,
and the chunk step through eager_chunk_step. The CTC loss keeps its
kernel either way. Nothing is tried and caught: the route is fixed before
any launch, and a kernel that fails raises. The eager layer module is also
the reference the tests hold the routes against.

Training draws from two torch.Generators, as masr_tpu from two rng
streams: `generator` (on the model's device) for every dropout and the
training kernel's per-(layer, utterance) seeds, `chunk_generator` (on the
CPU) for the dynamic chunk, so the CPU and the card draw the same chunk.

Streaming state (`ConformerEncoder.init_cache`) is a dict of device
tensors that every chunk step updates IN PLACE, for the slots it advances:
  att_cache (L, B, h, C, 2·d_k)  per-layer single-copy [K ‖ V] rings;
                                 chronological row j of slot s at physical
                                 row (wptr[s] + j) mod C
  cnn_cache (L, B, k-1, D)       conv-module input rows before pointwise_conv1
  offset, cache_len, wptr (B,)   int32: frames emitted, valid cache rows,
                                 ring write pointer
masr_tpu keeps the cache right-aligned (or, in its engine, as a mirrored
TPU ring) and returns new arrays; models/weights.py converts both ways.
A non-causal model steps its chunks eagerly (the chunk kernel takes a
causal conv), as masr_tpu's forward_chunk does, through the layers'
forward_cached with no cnn cache: its rings keep write pointer 0, so row j
is chronological row j, masr_tpu's right-aligned layout, and its cnn_cache
is one unused row per layer, as masr_tpu's.

bf16 serving (build_model(..., dtype=torch.bfloat16), masr_tpu's
dtype=bf16): the parameters stay f32; the encoder casts its features to
`compute_dtype` after CMVN, the eager modules compute in their input's
dtype (models/layers.py), the layer kernels take their bf16 mode (packs
whose products' weights are bf16, LN and bias rows f32), the streaming
caches and position tables are bf16, and the CTC probabilities leave in
f32.

bf16 training (the same model in training mode, masr_tpu's
train_conf.enable_amp): the parameters, the optimizer and the grads stay
f32; `forward_train` casts the features after CMVN; the subsampling, the
CTC head and the decoder are the eager modules in bf16 with torch's
differentiable products (models/layers.py: training mode), every layer
runs the training kernel's bf16 mode (pack_layer_params(layer, bf16)
built with grad; posp = linear_pos(pos_emb) as masr_tpu's, bf16 operands,
f32 sums, rounded once); the CTC logits and the decoder's leave in f32 for
the losses (row 4 stays f32, masr_tpu/models/losses.py:27).
"""
import torch
from torch import nn

from masr_tpu_torch.models.attention import (MultiHeadedSelfAttention,
                                             RelPositionMultiHeadedAttention,
                                             slot_key_mask)
from masr_tpu_torch.models.convolution import ConvolutionModule
from masr_tpu_torch.models.decoder import BiTransformerDecoder
from masr_tpu_torch.models.embedding import sinusoid_position_encoding
from masr_tpu_torch.models.layers import LayerNorm
from masr_tpu_torch.models.losses import CTCHead, label_smoothing_loss
from masr_tpu_torch.models.positionwise import PositionwiseFeedForward
from masr_tpu_torch.models.subsampling import subsampling_class
from masr_tpu_torch.ops.common import (IGNORE_ID, add_sos_eos, dropout,
                                       get_activation, reverse_pad_list,
                                       th_accuracy)
from masr_tpu_torch.ops.cuda.chunk_layer import (clamp_pos_starts,
                                                 fused_chunk_layer,
                                                 make_chunk_pos_table,
                                                 pack_chunk_tc)
from masr_tpu_torch.ops.cuda.conformer_layer import (fused_conformer_layer,
                                                     pack_layer_params)
from masr_tpu_torch.ops.cuda.conformer_layer_train import \
    fused_conformer_layer_train
from masr_tpu_torch.ops.dropout_hash import batch_row0, layer_seeds
from masr_tpu_torch.ops.masks import add_optional_chunk_mask, make_pad_mask

# encoder_conf keys that only steer masr_tpu's TPU routing: the port's route
# follows from the layer shape alone (ConformerEncoder.layer_route)
_IGNORED_ENCODER_KEYS = ("use_flash_attention", "use_fused_layer",
                         "use_fused_layer_train")


def _layer_norm(size):
    return LayerNorm(size, eps=1e-5)


def slot_positions(offsets, C, chunk, d_model):
    """(N, C + chunk, d_model): each slot's key positions offset - C ..
    offset + chunk - 1, clamped at 0 (masr_tpu's _chunk_pos_emb)."""
    rows = torch.clamp(offsets[:, None].long() - C
                       + torch.arange(C + chunk, device=offsets.device),
                       min=0)
    return sinusoid_position_encoding(rows.reshape(-1), d_model).view(
        offsets.shape[0], C + chunk, d_model)


def eager_chunk_step(chunk_fn, xs, state, active, rate=1):
    """One eager streaming step of the `active` slots (all when None) of a
    state with right-aligned caches. chunk_fn(xs, offsets, att_cache,
    cnn_cache, cache_lens) → (ys (n, c', D), new att cache, new cnn cache)
    runs the step on the active slots' rows; their caches are written back
    and their offsets and cache lengths advance by c' · rate frames, the
    other slots' state stays untouched. xs: (N, T_in, F) → (N, c', D), the
    inactive slots' rows zero."""
    if xs.dim() != 3:
        raise NotImplementedError("multi-chunk steps: the eager chunk step "
                                  "takes one window per slot")
    N = xs.shape[0]
    idx = None
    if active is not None:
        idx = torch.nonzero(active.to(xs.device, torch.bool)).flatten()
        if idx.numel() == N:
            idx = None
    att, cnn = state["att_cache"], state["cnn_cache"]

    def sub(t, dim):
        return t if idx is None else t.index_select(dim, idx)

    ys, new_att, new_cnn = chunk_fn(sub(xs, 0), sub(state["offset"], 0),
                                    sub(att, 1), sub(cnn, 1),
                                    sub(state["cache_len"], 0))
    step, C = ys.shape[1] * rate, att.shape[3]
    if idx is None:
        att.copy_(new_att)
        cnn.copy_(new_cnn)
        state["offset"].add_(step)
        state["cache_len"].copy_(torch.clamp(state["cache_len"] + step,
                                             max=C))
        return ys
    att.index_copy_(1, idx, new_att)
    cnn.index_copy_(1, idx, new_cnn)
    state["offset"][idx] += step
    state["cache_len"][idx] = torch.clamp(state["cache_len"][idx] + step,
                                          max=C)
    out = ys.new_zeros((N,) + tuple(ys.shape[1:]))
    out[idx] = ys
    return out


def kernel_layer_shape(pos_enc_layer_type="rel_pos", normalize_before=True,
                       macaron_style=True, use_cnn_module=True,
                       cnn_module_norm="layer_norm", activation_type="swish"):
    """Whether a Conformer layer shape is the layer kernels': masr_tpu's
    fused-route terms (masr_tpu/models/conformer.py:287-320: rel_pos,
    pre-norm, macaron, a layer_norm conv module) and SiLU, the one
    activation the kernels compute."""
    return (pos_enc_layer_type == "rel_pos" and normalize_before
            and macaron_style and use_cnn_module
            and cnn_module_norm == "layer_norm" and activation_type == "swish")


class ConformerEncoderLayer(nn.Module):
    """macaron-FFN(×0.5) → MHSA → conv → FFN(×0.5) → final LN, each
    sublayer a residual around it, pre-norm or post-norm
    (normalize_before), as masr_tpu's layer (masr_tpu/models/conformer.py
    :33-133): without macaron_style the macaron FFN goes and the FFN scale
    is 1; without a conv module the conv block and the final LN go; the
    attention is rel-pos (rel_pos) or plain. The layer kernels take the
    default shape alone (kernel_layer_shape)."""

    def __init__(self, size, attention_heads, linear_units,
                 cnn_module_kernel=15, causal=False,
                 activation_type="swish", cnn_module_norm="layer_norm",
                 dropout_rate=0.0, attention_dropout_rate=0.0,
                 self_attn=None, conv_module=None, normalize_before=True,
                 macaron_style=True, use_cnn_module=True, rel_pos=True):
        """self_attn, conv_module: modules that replace the MHSA and the
        conv module (the Efficient-Conformer's grouped attention and
        strided conv, models/efficient_conformer.py; a conv_module given
        is built whatever use_cnn_module says, as masr_tpu's stride
        layer); None builds them."""
        super().__init__()
        act = get_activation(activation_type)
        self.size = size
        self.attention_heads = attention_heads
        self.cnn_module_kernel = cnn_module_kernel
        self.causal = causal
        self.normalize_before = normalize_before
        self.macaron_style = macaron_style
        self.ff_scale = 0.5 if macaron_style else 1.0
        self.dropout_rate = dropout_rate
        self.attention_dropout_rate = attention_dropout_rate
        if self_attn is None:
            self_attn = (RelPositionMultiHeadedAttention if rel_pos
                         else MultiHeadedSelfAttention)(
                attention_heads, size, attention_dropout_rate)
        self.self_attn = self_attn
        self.feed_forward = PositionwiseFeedForward(size, linear_units, act,
                                                    dropout_rate)
        if macaron_style:
            self.feed_forward_macaron = PositionwiseFeedForward(
                size, linear_units, act, dropout_rate)
        if conv_module is None and use_cnn_module:
            conv_module = ConvolutionModule(size, cnn_module_kernel, act,
                                            cnn_module_norm, causal)
        self.conv_module = conv_module
        self.norm_ff = _layer_norm(size)
        self.norm_mha = _layer_norm(size)
        if macaron_style:
            self.norm_ff_macaron = _layer_norm(size)
        if conv_module is not None:
            self.norm_conv = _layer_norm(size)
            self.norm_final = _layer_norm(size)
        self._packed, self._packed_key = None, None
        self._chunk_packed = None

    def _residual(self, x, norm, sub):
        """x + sub(norm(x)) pre-norm, norm(x + sub(x)) post-norm."""
        if self.normalize_before:
            return x + sub(norm(x))
        return norm(x + sub(x))

    def _layer(self, x, attend, convolve, drop, generator=None):
        """The sublayers in masr_tpu's order. attend(y) → (out, new att
        cache), convolve(y) → (out, new cnn cache) → (x, new att cache,
        new cnn cache)."""
        caches = [None, None]

        def ffn(module):
            return lambda y: self.ff_scale * drop(module(y, generator))

        def att(y):
            out, caches[0] = attend(y)
            return drop(out)

        if self.macaron_style:
            x = self._residual(x, self.norm_ff_macaron,
                               ffn(self.feed_forward_macaron))
        x = self._residual(x, self.norm_mha, att)
        if self.conv_module is not None:
            conv, caches[1] = convolve(self.norm_conv(x)
                                       if self.normalize_before else x)
            x = self.conv_residual(x, drop(conv))
            if not self.normalize_before:
                x = self.norm_conv(x)
        x = self._residual(x, self.norm_ff, ffn(self.feed_forward))
        if self.conv_module is not None:
            x = self.norm_final(x)
        return x, caches[0], caches[1]

    def forward(self, x, mask, pos_emb, mask_pad, generator=None):
        """Eager reference, and the eager route. x: (B, T, D); mask: (B,
        1|T, T) bool; pos_emb: (1, T, D); mask_pad: (B, 1, T) bool. In
        training mode the dropouts draw from `generator`."""
        def drop(v):
            return dropout(v, self.dropout_rate, self.training, generator)

        return self._layer(
            x, lambda y: self.self_attn(y, mask, pos_emb,
                                        generator=generator),
            lambda y: self.conv_module(y, mask_pad), drop, generator)[0]

    def conv_residual(self, x, conv):
        """The conv block's residual sum: x + conv (a stride layer pools
        x to conv's rate first)."""
        return x + conv

    def forward_cached(self, x, mask, pos_emb, att_cache, cnn_cache):
        """Eager reference of one streaming step with masr_tpu's caches.
        x: (B, c, D); mask: (B, 1, C + c) bool (cache_key_mask); pos_emb:
        (1|B, C + c, D); att_cache: right-aligned (B, h, C, 2·d_k);
        cnn_cache: (B, k-1, D) or None → (x, new att cache, new cnn cache
        or None)."""
        return self._layer(
            x, lambda y: self.self_attn(y, mask, pos_emb, att_cache),
            lambda y: self.conv_module(y, None, cnn_cache), lambda v: v)

    def packed_params(self, dtype=torch.float32):
        """The kernel's packed weights, the products' in `dtype` (the
        compute dtype), repacked only when a parameter was moved or
        modified in place (tracked by data_ptr and _version) or the dtype
        changes."""
        key = (dtype,) + tuple((p.data_ptr(), p._version)
                               for p in self.parameters())
        if key != self._packed_key:
            with torch.no_grad():
                self._packed = pack_layer_params(self, dtype)
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

    def forward_train(self, x, mask, seeds, lens, pos_emb, index):
        """The layer through the training-layer kernel, differentiable in x
        and every parameter (packed with grad enabled, so the kernel's
        weight grads reach the parameters), in x's dtype (f32, or bf16: the
        kernel's bf16 mode, its posp a bf16 product as masr_tpu's,
        masr_tpu/models/conformer.py:157-162). mask: (B, T, T) bool; seeds:
        (B,) int32 dropout seeds of this layer; index: the layer's index;
        dropout only in training mode."""
        train, dtype = self.training, x.dtype
        return fused_conformer_layer_train(
            x, mask, seeds, lens,
            self.self_attn.linear_pos(pos_emb[0].to(dtype)),
            pack_layer_params(self, dtype), layer=index,
            n_head=self.attention_heads, ksize=self.cnn_module_kernel,
            causal=self.causal, ff_scale=self.ff_scale,
            rate=self.dropout_rate if train else 0.0,
            att_rate=self.attention_dropout_rate if train else 0.0,
            row0=batch_row0(x.shape[0]))

    def forward_full_context(self, x, lens, pos_emb):
        """The layer through the full-context kernel, which reads the
        serving tensor-core pack (chunk_packed_params; its plain twin on a
        CPU tensor does not), in x's dtype (f32, or bf16: the kernel's bf16
        mode). lens: (B,) int32."""
        pos_p = self.self_attn.linear_pos(pos_emb[0].to(x.dtype))
        packed = (self.chunk_packed_params(x.dtype) if x.is_cuda
                  else self.packed_params(x.dtype))
        return fused_conformer_layer(
            x, lens, pos_p, packed, n_head=self.attention_heads,
            ksize=self.cnn_module_kernel, causal=self.causal,
            ff_scale=self.ff_scale)


class ConformerEncoder(nn.Module):
    """Full-context encoder: CMVN → subsampling → layers → after_norm."""

    # position_tables: the chunk step can read its positions from per-layer
    # tables (pack_chunk_params with a cache_size); the engine routes slots
    # past a table's horizon to the exact-positions step. multi_chunk: it
    # takes k windows per slot as one step. Both hold for a causal model.

    def __init__(self, input_size, output_size=256, attention_heads=4,
                 linear_units=2048, num_blocks=6, input_layer="conv2d",
                 pos_enc_layer_type="rel_pos", normalize_before=True,
                 static_chunk_size=0, use_dynamic_chunk=False,
                 macaron_style=True, activation_type="swish",
                 use_cnn_module=True, cnn_module_kernel=15, causal=False,
                 cnn_module_norm="layer_norm", dropout_rate=0.1,
                 positional_dropout_rate=0.1, attention_dropout_rate=0.0,
                 use_dynamic_left_chunk=False, cmvn=None,
                 dtype=torch.float32, **conf):
        super().__init__()
        unknown = set(conf) - set(_IGNORED_ENCODER_KEYS)
        if unknown:
            raise TypeError(f"unknown encoder_conf keys: {sorted(unknown)}")
        self._layer_route = "kernel" if kernel_layer_shape(
            pos_enc_layer_type, normalize_before, macaron_style,
            use_cnn_module, cnn_module_norm, activation_type) else "eager"
        self.global_cmvn = cmvn
        self.compute_dtype = dtype
        self.output_size = output_size
        self.attention_heads = attention_heads
        self.causal = causal
        self.normalize_before = normalize_before
        # the chunk kernel steps a causal model of the kernels' shape; any
        # other steps eagerly: no tables, one window a step
        self.chunk_kernel = causal and self._layer_route == "kernel"
        self.position_tables = self.multi_chunk = self.chunk_kernel
        self.cnn_module_kernel = cnn_module_kernel
        self.use_dynamic_chunk = use_dynamic_chunk
        self.use_dynamic_left_chunk = use_dynamic_left_chunk
        self.static_chunk_size = static_chunk_size
        self.dropout_rate = dropout_rate
        self.attention_dropout_rate = attention_dropout_rate
        self.embed = subsampling_class(input_layer)(
            input_size, output_size, positional_dropout_rate,
            pos_enc_type=pos_enc_layer_type, dropout_rate=dropout_rate)
        self.encoders = nn.ModuleList(
            ConformerEncoderLayer(output_size, attention_heads, linear_units,
                                  cnn_module_kernel, causal, activation_type,
                                  cnn_module_norm, dropout_rate,
                                  attention_dropout_rate,
                                  normalize_before=normalize_before,
                                  macaron_style=macaron_style,
                                  use_cnn_module=use_cnn_module,
                                  rel_pos=pos_enc_layer_type == "rel_pos")
            for _ in range(num_blocks))
        # masr_tpu's post-norm stack calls (so holds) no after_norm
        self.after_norm = _layer_norm(output_size) if normalize_before \
            else None

    @property
    def layer_route(self):
        """"kernel" when the layer shape is the layer kernels'
        (kernel_layer_shape: the full-context, chunk and training kernels
        run every layer), else "eager": the eager layers on every route,
        on the tensors' own device, as masr_tpu keeps such shapes on XLA.
        Fixed at construction from the config."""
        return self._layer_route

    def _after_norm(self, xs):
        """after_norm, which masr_tpu applies to a pre-norm stack alone."""
        return self.after_norm(xs) if self.normalize_before else xs

    def forward(self, xs, xs_lens):
        """Full context (masr_tpu's __call__ at decoding_chunk_size -1).
        xs: (B, T, F) f32; xs_lens: (B,) → (out (B, T', D), masks (B, 1, T')
        bool). A static-chunk model (static_chunk_size > 0, no dynamic
        chunk) keeps its block mask, as masr_tpu: its layers run eagerly
        under add_optional_chunk_mask's (B, T', T') mask, their attention
        through the flash route; so do the layers of an eager layer_route
        under the full mask; every other model runs each layer through the
        full-context layer kernel."""
        masks = ~make_pad_mask(xs_lens, xs.shape[1])[:, None, :]
        xs, pos_emb, masks = self.embed(self._features(xs), masks)
        if (self.static_chunk_size > 0 and not self.use_dynamic_chunk) \
                or self._layer_route == "eager":
            chunk_masks = add_optional_chunk_mask(
                xs.shape[1], masks, self.use_dynamic_chunk, False, -1,
                self.static_chunk_size, -1)
            for layer in self.encoders:
                xs = layer(xs, chunk_masks, pos_emb, masks)
        else:
            lens = masks[:, 0, :].sum(dim=1, dtype=torch.int32)
            for layer in self.encoders:
                xs = layer.forward_full_context(xs, lens, pos_emb)
        return self._after_norm(xs), masks

    def _features(self, xs):
        """CMVN in f32, then the compute dtype (masr_tpu casts after CMVN,
        masr_tpu/models/conformer.py:242, :367, :450)."""
        if self.global_cmvn is not None:
            xs = self.global_cmvn(xs)
        return xs.to(self.compute_dtype)

    def forward_train(self, xs, xs_lens, generator=None,
                      chunk_generator=None):
        """The loss path (masr_tpu's __call__ with train): subsampling with
        positional dropout, the (B, T', T') chunk mask (a dynamic chunk is
        drawn from chunk_generator), every layer through the training-layer
        kernel with per-(layer, utterance) seeds from `generator` (the
        eager layers under autograd, their dropouts drawn from it, on an
        eager layer_route), in the compute dtype after CMVN. Dropout only
        in training mode. → (out (B, T', D), masks (B, 1, T'))."""
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
            seeds = layer_seeds(len(self.encoders), B, generator,
                                xs.device)
        else:
            seeds = torch.zeros(len(self.encoders), B, dtype=torch.int32,
                                device=xs.device)
        if self._layer_route == "eager":
            for layer in self.encoders:
                xs = layer(xs, chunk_masks, pos_emb, masks, generator)
            return self._after_norm(xs), masks
        for i, layer in enumerate(self.encoders):
            xs = layer.forward_train(xs, chunk_masks, seeds[i], lens, pos_emb,
                                     i)
        return self.after_norm(xs), masks

    def init_cache(self, batch=1, cache_size=256, device=None):
        """Zeroed streaming state for `batch` slots with C = cache_size
        cache rows per layer (the layout of the module docstring); the att
        and cnn caches in the compute dtype, as masr_tpu keeps them."""
        if cache_size < 0:
            raise ValueError(f"cache_size {cache_size}: the streaming "
                             "caches have a fixed size >= 0")
        L, d_k = len(self.encoders), self.output_size // self.attention_heads

        def zeros(*shape, dtype=self.compute_dtype):
            return torch.zeros(shape, dtype=dtype, device=device)

        return {"att_cache": zeros(L, batch, self.attention_heads,
                                   cache_size, 2 * d_k),
                "cnn_cache": zeros(L, batch, self.cnn_module_kernel - 1
                                   if self.causal else 1, self.output_size),
                "offset": zeros(batch, dtype=torch.int32),
                "cache_len": zeros(batch, dtype=torch.int32),
                "wptr": zeros(batch, dtype=torch.int32)}

    def pack_chunk_params(self, cache_size=None, pos_table_len=8192):
        """Per layer: (kernel weights with the serving tensor-core pack,
        chunk_packed_params; position table or None). With
        cache_size, each layer gets its make_chunk_pos_table rows, and the
        chunk step reads every slot's position window from them in place
        of a per-step sinusoid and linear_pos product. Computed once per
        session. Both in the compute dtype. A model that steps eagerly
        (non-causal, or an eager layer_route) packs nothing (None)."""
        if not self.chunk_kernel:
            return None
        dtype = self.compute_dtype
        with torch.no_grad():
            return [(layer.chunk_packed_params(dtype),
                     None if cache_size is None else make_chunk_pos_table(
                         layer.self_attn.linear_pos.weight, cache_size,
                         pos_table_len, dtype))
                    for layer in self.encoders]

    @torch.no_grad()
    def forward_chunk_batched(self, xs, state, packed=None, active=None,
                              exact_positions=False):
        """One streaming step of every slot of `state` through the chunk
        kernel, with per-slot offsets and cache validity.

        xs: (N, T_in, F) one feature window per slot, T_in = (c-1)·4 + 7;
        or (N, k, T_in, F), k windows per slot run as ONE multi-chunk step
        (block-causal over the k sub-chunks, equal to k single steps).
        packed: pack_chunk_params(); with position tables, slots read their
        positions from the tables unless exact_positions. active: (N,) bool
        or None (all); the caches and counters of inactive slots stay
        untouched. → (N, c·k, D); the state advances in place. A
        non-causal model, or one of an eager layer_route, takes the eager
        step (_chunk_eager), one window per slot."""
        if not self.chunk_kernel:
            return eager_chunk_step(self._chunk_eager, xs, state, active)
        n_sub = 1
        if xs.dim() == 4:
            n_sub = xs.shape[1]
            xs = xs.reshape((-1,) + tuple(xs.shape[2:]))
        # each window subsamples on its own, as sequential steps feed them;
        # the chunk's positions come from the offsets below
        xs = self.embed(self._features(xs))[0]
        if n_sub > 1:
            xs = xs.reshape(xs.shape[0] // n_sub, -1, xs.shape[2])
        N, chunk = xs.shape[0], xs.shape[1]
        att, cnn = state["att_cache"], state["cnn_cache"]
        C, L, dev = att.shape[3], att.shape[3] + xs.shape[1], xs.device
        if packed is None:
            packed = self.pack_chunk_params()
        if active is None:
            active = torch.ones(N, dtype=torch.bool, device=dev)
        active = active.to(dev, torch.bool)
        use_table = packed[0][1] is not None and not exact_positions
        if use_table:
            starts = clamp_pos_starts(state["offset"], packed[0][1].shape[0],
                                      L)
        else:
            pe = slot_positions(state["offset"], C, xs.shape[1],
                                self.output_size).reshape(N * L, -1)
            starts = torch.arange(N, dtype=torch.int32, device=dev) * L
        act_i32 = active.to(torch.int32)
        for i, layer in enumerate(self.encoders):
            pos = packed[i][1] if use_table else \
                layer.self_attn.linear_pos(pe.to(xs.dtype))
            xs = fused_chunk_layer(
                xs, pos, starts, att[i], cnn[i], state["cache_len"],
                state["wptr"], act_i32, packed[i][0],
                n_head=layer.attention_heads, ksize=layer.cnn_module_kernel,
                n_sub=n_sub, ff_scale=layer.ff_scale)
        step = act_i32 * chunk
        state["offset"].add_(step)
        state["cache_len"].copy_(torch.clamp(state["cache_len"] + step,
                                             max=C))
        if C:
            state["wptr"].copy_((state["wptr"] + step) % C)
        return self.after_norm(xs)

    def _chunk_eager(self, xs, offsets, att_cache, cnn_cache, cache_lens):
        """masr_tpu's forward_chunk (:353-389) with per-slot offsets and
        cache lengths: the eager cached layers, a causal conv module's cnn
        cache in and out (a non-causal one convolves within the chunk)
        → (ys (N, c, D), new right-aligned att cache, new cnn cache)."""
        cur = self.embed(self._features(xs), offset=offsets)[0]
        C, chunk = att_cache.shape[3], cur.shape[1]
        pos = slot_positions(offsets, C, chunk, self.output_size)
        mask = slot_key_mask(C, chunk, cache_lens)
        new_att, new_cnn = [], []
        for i, layer in enumerate(self.encoders):
            cnn = cnn_cache[i] if self.causal else None
            cur, a, c = layer.forward_cached(cur, mask, pos, att_cache[i],
                                             cnn)
            new_att.append(a)
            new_cnn.append(cnn_cache[i] if c is None else c)
        return self._after_norm(cur), torch.stack(new_att), \
            torch.stack(new_cnn)

    def forward_chunk(self, xs, state):
        """One streaming chunk of every slot (masr_tpu's forward_chunk):
        exact positions from the offsets, all slots active. xs: (B, T_in,
        F) → (B, c, D); the state advances in place."""
        return self.forward_chunk_batched(xs, state, exact_positions=True)


class ConformerModel(nn.Module):
    """Encoder + CTC head + bidirectional attention decoder, trained with
    the hybrid loss (masr_tpu/models/conformer.py:638-736)."""

    has_attention_decoder = True

    def __init__(self, input_dim, vocab_size, cmvn=None, streaming=True,
                 encoder_conf=None, decoder_conf=None, ctc_weight=0.5,
                 ignore_id=IGNORE_ID, reverse_weight=0.0, lsm_weight=0.0,
                 length_normalized_loss=False, dtype=torch.float32):
        """dtype: the compute dtype (f32, or bf16 for the Conformer's bf16
        serving; the encoder's compute_dtype, which the decoder follows)."""
        super().__init__()
        if not 0.0 <= ctc_weight <= 1.0:
            raise ValueError(f"ctc_weight {ctc_weight} not in [0, 1]")
        enc_conf = dict(encoder_conf or {})
        if dtype != torch.float32:
            enc_conf["dtype"] = dtype
        self.encoder = self.make_encoder(input_dim, cmvn, streaming,
                                         enc_conf)
        D = self.encoder.output_size
        self.decoder = BiTransformerDecoder(vocab_size, D,
                                            **dict(decoder_conf or {}))
        self.ctc = CTCHead(D, vocab_size)
        self.vocab_size = vocab_size
        self.ctc_weight = ctc_weight
        self.ignore_id = ignore_id
        self.reverse_weight = reverse_weight
        self.lsm_weight = lsm_weight
        self.length_normalized_loss = length_normalized_loss
        # sos == eos == the last token (the vocabulary's <eos>)
        self.sos = self.eos = vocab_size - 1

    def make_encoder(self, input_dim, cmvn, streaming, enc_conf):
        """The family's encoder; streaming makes the chunk mask dynamic and
        the conv causal unless encoder_conf says otherwise."""
        enc_conf.setdefault("use_dynamic_chunk", streaming)
        enc_conf.setdefault("causal", streaming)
        return ConformerEncoder(input_dim, cmvn=cmvn, **enc_conf)

    @property
    def decoder_state(self):
        """The attention decoder's weights under their upstream names."""
        return {"decoder." + k: v for k, v in self.decoder.state_dict().items()}

    def forward(self, speech, speech_lengths, text, text_lengths,
                generator=None, chunk_generator=None):
        """The hybrid loss → {'loss', 'loss_att', 'loss_ctc', 'acc_att'}
        (scalars). speech (B, T, F) f32, speech_lengths (B,), text (B, L)
        padded with -1, text_lengths (B,). Dropout in training mode, drawn
        from `generator`; the dynamic chunk from `chunk_generator`."""
        encoder_out, encoder_mask = self.encoder.forward_train(
            speech, speech_lengths, generator, chunk_generator)
        encoder_lens = encoder_mask[:, 0, :].sum(dim=1, dtype=torch.int32)
        zero = torch.zeros((), device=encoder_out.device)
        loss_att, acc_att, loss_ctc = zero, zero, zero
        if self.ctc_weight != 1.0:
            loss_att, acc_att = self._calc_att_loss(
                encoder_out, encoder_mask, text, text_lengths, generator)
        if self.ctc_weight != 0.0:
            loss_ctc = self.ctc(encoder_out, encoder_lens, text,
                                text_lengths)
        if self.ctc_weight == 0.0:
            loss = loss_att
        elif self.ctc_weight == 1.0:
            loss = loss_ctc
        else:
            loss = self.ctc_weight * loss_ctc + \
                (1 - self.ctc_weight) * loss_att
        return {"loss": loss, "loss_att": loss_att, "loss_ctc": loss_ctc,
                "acc_att": acc_att}

    def _calc_att_loss(self, encoder_out, encoder_mask, ys_pad, ys_pad_lens,
                       generator):
        ys_in, ys_out = add_sos_eos(ys_pad, ys_pad_lens, self.sos, self.eos,
                                    self.ignore_id)
        r_ys_pad = reverse_pad_list(ys_pad, ys_pad_lens, self.ignore_id)
        r_ys_in, r_ys_out = add_sos_eos(r_ys_pad, ys_pad_lens, self.sos,
                                        self.eos, self.ignore_id)
        decoder_out, r_decoder_out = self.decoder(
            encoder_out, encoder_mask, ys_in, ys_pad_lens + 1, r_ys_in,
            self.reverse_weight, generator)
        loss_att = label_smoothing_loss(
            decoder_out, ys_out, self.vocab_size, self.ignore_id,
            self.lsm_weight, self.length_normalized_loss, self.training)
        if r_decoder_out is not None:
            r_loss_att = label_smoothing_loss(
                r_decoder_out, r_ys_out, self.vocab_size, self.ignore_id,
                self.lsm_weight, self.length_normalized_loss,
                self.training)
            loss_att = loss_att * (1 - self.reverse_weight) + \
                r_loss_att * self.reverse_weight
        acc_att = th_accuracy(decoder_out.reshape(-1, self.vocab_size),
                              ys_out, self.ignore_id)
        return loss_att, acc_att

    def get_encoder_out(self, speech, speech_lengths):
        """Full-context CTC softmax → (probs (B, T', V), out_lens (B,))."""
        encoder_out, mask = self.encoder(speech, speech_lengths)
        lens = mask[:, 0, :].sum(dim=1, dtype=torch.int32)
        return self.ctc.softmax(encoder_out), lens

    def get_encoder_out_chunk(self, speech, state):
        """Streaming chunk step → CTC probs (B, c, V); `state`
        (encoder.init_cache) advances in place."""
        return self.ctc.softmax(self.encoder.forward_chunk(speech, state))

    def get_encoder_out_chunk_batched(self, speech, state, packed=None,
                                      active=None, exact_positions=False):
        """Batched streaming step over the slots of `state` with per-slot
        offsets and validity (encoder.forward_chunk_batched) → CTC probs
        (N, c·k, V); the active slots' state advances in place."""
        return self.ctc.softmax(self.encoder.forward_chunk_batched(
            speech, state, packed, active, exact_positions))

    def get_encoder_out_chunk_full(self, speech, state):
        """get_encoder_out_chunk that also returns the encoder's output
        rows (B, c, D), the chunk kernel's output after after_norm: the
        predictor keeps them for attention rescoring at the end of a stream
        (two-pass streaming). → (probs, hidden)."""
        hidden = self.encoder.forward_chunk(speech, state)
        return self.ctc.softmax(hidden), hidden

    def encode_for_rescoring(self, speech, speech_lengths):
        """The full-context encode of get_encoder_out (the layer kernels)
        → (encoder_out (B, T', D), CTC probs (B, T', V), out_lens (B,)):
        the encoder rows feed attention rescoring without a second
        encode."""
        encoder_out, mask = self.encoder(speech, speech_lengths)
        lens = mask[:, 0, :].sum(dim=1, dtype=torch.int32)
        return encoder_out, self.ctc.softmax(encoder_out), lens

    @staticmethod
    def _gather_hyp_scores(logp, ys_out, ignore_id):
        """Sum of each hypothesis's per-token log-probs, its <eos>
        included. logp (N, L+1, V), ys_out (N, L+1) → (N,)."""
        valid = ys_out != ignore_id
        tgt = torch.where(valid, ys_out, torch.zeros_like(ys_out))
        tok = torch.gather(logp, 2, tgt[..., None].long())[..., 0]
        return torch.where(valid, tok, torch.zeros_like(tok)).sum(dim=1)

    @torch.no_grad()
    def rescore_hyps(self, encoder_out, encoder_len, hyps, hyps_lens,
                     reverse_weight=0.0):
        """Attention-rescoring scores of N hypotheses over ONE utterance.
        encoder_out: (1, T, D); encoder_len: its valid rows; hyps: (N, L)
        token ids padded with -1; hyps_lens: (N,) → (N,) scores =
        (1-rw)·left-decoder + rw·right-decoder log-likelihoods (rw =
        reverse_weight, 0 without a right decoder). Rows are independent:
        a padding row (length 0) changes no other row's score. The decoder
        runs without dropout whatever the model's mode, as masr_tpu's
        rescore_hyps calls it with train=False."""
        N = hyps.shape[0]
        T = encoder_out.shape[1]
        dev = encoder_out.device
        hyps = torch.as_tensor(hyps, device=dev).long()
        hyps_lens = torch.as_tensor(hyps_lens, device=dev).long()
        enc = encoder_out.expand((N,) + tuple(encoder_out.shape[1:]))
        enc_mask = (torch.arange(T, device=dev)
                    < torch.as_tensor(encoder_len, device=dev))[None, None]
        enc_mask = enc_mask.expand(N, 1, T)
        ys_in, ys_out = add_sos_eos(hyps, hyps_lens, self.sos, self.eos,
                                    self.ignore_id)
        r_hyps = reverse_pad_list(hyps, hyps_lens, self.ignore_id)
        r_ys_in, r_ys_out = add_sos_eos(r_hyps, hyps_lens, self.sos,
                                        self.eos, self.ignore_id)
        training = self.decoder.training
        self.decoder.eval()
        try:
            decoder_out, r_decoder_out = self.decoder(
                enc, enc_mask, ys_in, hyps_lens + 1, r_ys_in,
                reverse_weight)
        finally:
            self.decoder.train(training)
        logp = torch.log_softmax(decoder_out.float(), dim=-1)
        scores = self._gather_hyp_scores(logp, ys_out, self.ignore_id)
        if reverse_weight > 0.0 and self.decoder.r_num_blocks > 0:
            r_logp = torch.log_softmax(r_decoder_out.float(), dim=-1)
            r_scores = self._gather_hyp_scores(r_logp, r_ys_out,
                                               self.ignore_id)
            scores = (1 - reverse_weight) * scores \
                + reverse_weight * r_scores
        return scores

