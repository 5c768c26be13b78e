"""Conformer encoder and model: full-context and streaming inference and
training with the hybrid CTC + attention loss (port of
masr_tpu/models/conformer.py: ConformerEncoderLayer.__call__ :92-133,
ConformerEncoder.__call__ :235-273, forward_chunk :353-395,
forward_chunk_batched :417-561, pack_chunk_params :563-586, init_cache
:588-621, ConformerModel.__call__ :686-736, get_encoder_out :738-749,
get_encoder_out_chunk :751-763, get_encoder_out_chunk_batched :789-836).

Module names follow upstream MASR (`encoder.encoders.{i}.self_attn...`,
`ctc.ctc_lo`, `decoder.left_decoder...`), so `models/weights.py` maps flax
bundles and upstream checkpoints onto them. The encoder runs every layer
through a layer kernel: the full-context one (ops/cuda/conformer_layer.py)
offline, the chunk one (ops/cuda/chunk_layer.py) when streaming, and the
training one (ops/cuda/conformer_layer_train.py, forward and backward) in
`forward_train`, the loss path; the CUDA kernel for CUDA tensors, its plain
twin for CPU tensors. The one exception is the offline encode of a
static-chunk model: it runs the eager layer module below, as masr_tpu runs
its XLA layers there, and their attention takes the masked attention
kernel (ops/cuda/rel_pos_attention.py, models/attention.py's flash route).
The eager layer module is also the reference the tests hold the routes
against.

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
"""
import torch
from torch import nn

from masr_tpu_torch.models.attention import RelPositionMultiHeadedAttention
from masr_tpu_torch.models.convolution import ConvolutionModule
from masr_tpu_torch.models.decoder import BiTransformerDecoder
from masr_tpu_torch.models.embedding import sinusoid_position_encoding
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
from masr_tpu_torch.ops.masks import add_optional_chunk_mask, make_pad_mask

# encoder_conf keys that only steer masr_tpu's TPU routing: every layer of
# the port runs its kernel, with no gate to switch
_IGNORED_ENCODER_KEYS = ("use_flash_attention", "use_fused_layer",
                         "use_fused_layer_train")


def _layer_norm(size):
    return nn.LayerNorm(size, eps=1e-5)


class ConformerEncoderLayer(nn.Module):
    """macaron-FFN(×0.5) → rel-pos MHSA → conv → FFN(×0.5) → final LN
    (pre-norm). This slice ports the layer shape of every shipped
    Conformer config: rel_pos, normalize_before, macaron, conv module."""

    def __init__(self, size, attention_heads, linear_units,
                 cnn_module_kernel=15, causal=False,
                 activation_type="swish", cnn_module_norm="layer_norm",
                 dropout_rate=0.0, attention_dropout_rate=0.0):
        super().__init__()
        act = get_activation(activation_type)
        self.size = size
        self.attention_heads = attention_heads
        self.cnn_module_kernel = cnn_module_kernel
        self.causal = causal
        self.ff_scale = 0.5
        self.dropout_rate = dropout_rate
        self.attention_dropout_rate = attention_dropout_rate
        self.self_attn = RelPositionMultiHeadedAttention(
            attention_heads, size, attention_dropout_rate)
        self.feed_forward = PositionwiseFeedForward(size, linear_units, act,
                                                    dropout_rate)
        self.feed_forward_macaron = PositionwiseFeedForward(
            size, linear_units, act, dropout_rate)
        self.conv_module = ConvolutionModule(size, cnn_module_kernel, act,
                                             cnn_module_norm, causal)
        self.norm_ff = _layer_norm(size)
        self.norm_mha = _layer_norm(size)
        self.norm_ff_macaron = _layer_norm(size)
        self.norm_conv = _layer_norm(size)
        self.norm_final = _layer_norm(size)
        self._packed, self._packed_key = None, None
        self._chunk_packed = None

    def forward(self, x, mask, pos_emb, mask_pad, generator=None):
        """Eager reference. x: (B, T, D); mask: (B, 1|T, T) bool;
        pos_emb: (1, T, D); mask_pad: (B, 1, T) bool. In training mode
        the dropouts draw from `generator`."""
        def drop(v):
            return dropout(v, self.dropout_rate, self.training, generator)

        x = x + self.ff_scale * drop(self.feed_forward_macaron(
            self.norm_ff_macaron(x), generator))
        x = x + drop(self.self_attn(self.norm_mha(x), mask, pos_emb,
                                    generator=generator)[0])
        x = x + drop(self.conv_module(self.norm_conv(x), mask_pad)[0])
        x = x + self.ff_scale * drop(self.feed_forward(self.norm_ff(x),
                                                       generator))
        return self.norm_final(x)

    def forward_cached(self, x, mask, pos_emb, att_cache, cnn_cache):
        """Eager reference of one streaming step with masr_tpu's caches.
        x: (B, c, D); mask: (B, 1, C + c) bool (cache_key_mask); pos_emb:
        (1, C + c, D); att_cache: right-aligned (B, h, C, 2·d_k); cnn_cache:
        (B, k-1, D) → (x, new att cache, new cnn cache)."""
        x = x + self.ff_scale * self.feed_forward_macaron(
            self.norm_ff_macaron(x))
        att, new_att = self.self_attn(self.norm_mha(x), mask, pos_emb,
                                      att_cache)
        x = x + att
        conv, new_cnn = self.conv_module(self.norm_conv(x), None, cnn_cache)
        x = x + conv
        x = x + self.ff_scale * self.feed_forward(self.norm_ff(x))
        return self.norm_final(x), new_att, new_cnn

    def packed_params(self):
        """The kernel's packed weights, repacked only when a parameter was
        moved or modified in place (tracked by data_ptr and _version)."""
        key = tuple((p.data_ptr(), p._version) for p in self.parameters())
        if key != self._packed_key:
            with torch.no_grad():
                self._packed = pack_layer_params(self)
            self._packed_key = key
        return self._packed

    def chunk_packed_params(self):
        """packed_params() with the serving tensor-core pack of the chunk
        kernel (pack_chunk_tc), rebuilt only when packed_params() is."""
        packed = self.packed_params()
        if self._chunk_packed is None or self._chunk_packed[0] is not packed:
            with torch.no_grad():
                self._chunk_packed = (packed,
                                      {**packed, **pack_chunk_tc(packed)})
        return self._chunk_packed[1]

    def forward_train(self, x, mask, seeds, lens, pos_emb, index):
        """The layer through the training-layer kernel, differentiable in x
        and every parameter (packed with grad enabled, so the kernel's
        weight grads reach the parameters). mask: (B, T, T) bool; seeds:
        (B,) int32 dropout seeds of this layer; index: the layer's index;
        dropout only in training mode."""
        train = self.training
        return fused_conformer_layer_train(
            x, mask, seeds, lens, self.self_attn.linear_pos(pos_emb[0]),
            pack_layer_params(self), layer=index,
            n_head=self.attention_heads, ksize=self.cnn_module_kernel,
            causal=self.causal, ff_scale=self.ff_scale,
            rate=self.dropout_rate if train else 0.0,
            att_rate=self.attention_dropout_rate if train else 0.0)

    def forward_full_context(self, x, lens, pos_emb):
        """The layer through the full-context kernel, which reads the
        serving tensor-core pack (chunk_packed_params; its plain twin on a
        CPU tensor does not). lens: (B,) int32."""
        pos_p = self.self_attn.linear_pos(pos_emb[0])
        packed = (self.chunk_packed_params() if x.is_cuda
                  else self.packed_params())
        return fused_conformer_layer(
            x, lens, pos_p, packed, n_head=self.attention_heads,
            ksize=self.cnn_module_kernel, causal=self.causal,
            ff_scale=self.ff_scale)


class ConformerEncoder(nn.Module):
    """Full-context encoder: CMVN → subsampling → layers → after_norm."""

    # the chunk step can read its positions from per-layer tables
    # (pack_chunk_params with a cache_size); the engine routes slots past a
    # table's horizon to the exact-positions step
    position_tables = True

    def __init__(self, input_size, output_size=256, attention_heads=4,
                 linear_units=2048, num_blocks=6, input_layer="conv2d",
                 pos_enc_layer_type="rel_pos", normalize_before=True,
                 static_chunk_size=0, use_dynamic_chunk=False,
                 macaron_style=True, activation_type="swish",
                 use_cnn_module=True, cnn_module_kernel=15, causal=False,
                 cnn_module_norm="layer_norm", dropout_rate=0.1,
                 positional_dropout_rate=0.1, attention_dropout_rate=0.0,
                 use_dynamic_left_chunk=False, cmvn=None, **conf):
        super().__init__()
        unknown = set(conf) - set(_IGNORED_ENCODER_KEYS)
        if unknown:
            raise TypeError(f"unknown encoder_conf keys: {sorted(unknown)}")
        # the layer kernels take exactly this layer shape
        for ok, what in (
                (pos_enc_layer_type == "rel_pos", "pos_enc_layer_type "
                 f"{pos_enc_layer_type!r} (the kernel takes rel_pos)"),
                (normalize_before, "normalize_before=False"),
                (macaron_style, "macaron_style=False"),
                (use_cnn_module, "use_cnn_module=False"),
                (cnn_module_norm == "layer_norm",
                 f"cnn_module_norm {cnn_module_norm!r}")):
            if not ok:
                raise NotImplementedError(
                    f"{what}: the layer kernels do not take this layer "
                    "shape")
        self.global_cmvn = cmvn
        self.output_size = output_size
        self.attention_heads = attention_heads
        self.causal = causal
        self.cnn_module_kernel = cnn_module_kernel
        self.use_dynamic_chunk = use_dynamic_chunk
        self.use_dynamic_left_chunk = use_dynamic_left_chunk
        self.static_chunk_size = static_chunk_size
        self.dropout_rate = dropout_rate
        self.attention_dropout_rate = attention_dropout_rate
        self.embed = subsampling_class(input_layer)(input_size, output_size,
                                                    positional_dropout_rate)
        self.encoders = nn.ModuleList(
            ConformerEncoderLayer(output_size, attention_heads, linear_units,
                                  cnn_module_kernel, causal, activation_type,
                                  cnn_module_norm, dropout_rate,
                                  attention_dropout_rate)
            for _ in range(num_blocks))
        self.after_norm = _layer_norm(output_size)

    def forward(self, xs, xs_lens):
        """Full context (masr_tpu's __call__ at decoding_chunk_size -1).
        xs: (B, T, F) f32; xs_lens: (B,) → (out (B, T', D), masks (B, 1, T')
        bool). A static-chunk model (static_chunk_size > 0, no dynamic
        chunk) keeps its block mask, as masr_tpu: its layers run eagerly
        under add_optional_chunk_mask's (B, T', T') mask, their attention
        through the flash route; every other model runs each layer through
        the full-context layer kernel."""
        masks = ~make_pad_mask(xs_lens, xs.shape[1])[:, None, :]
        if self.global_cmvn is not None:
            xs = self.global_cmvn(xs)
        xs, pos_emb, masks = self.embed(xs, masks)
        if self.static_chunk_size > 0 and not self.use_dynamic_chunk:
            chunk_masks = add_optional_chunk_mask(
                xs.shape[1], masks, False, False, -1, self.static_chunk_size,
                -1)
            for layer in self.encoders:
                xs = layer(xs, chunk_masks, pos_emb, masks)
        else:
            lens = masks[:, 0, :].sum(dim=1, dtype=torch.int32)
            for layer in self.encoders:
                xs = layer.forward_full_context(xs, lens, pos_emb)
        return self.after_norm(xs), masks

    def forward_train(self, xs, xs_lens, generator=None,
                      chunk_generator=None):
        """The loss path (masr_tpu's __call__ with train): subsampling with
        positional dropout, the (B, T', T') chunk mask (a dynamic chunk is
        drawn from chunk_generator), every layer through the training-layer
        kernel with per-(layer, utterance) seeds from `generator`. Dropout
        only in training mode. → (out (B, T', D), masks (B, 1, T'))."""
        masks = ~make_pad_mask(xs_lens, xs.shape[1])[:, None, :]
        if self.global_cmvn is not None:
            xs = self.global_cmvn(xs)
        xs, pos_emb, masks = self.embed(xs, masks, generator=generator)
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
        for i, layer in enumerate(self.encoders):
            xs = layer.forward_train(xs, chunk_masks, seeds[i], lens, pos_emb,
                                     i)
        return self.after_norm(xs), masks

    def init_cache(self, batch=1, cache_size=256, device=None):
        """Zeroed streaming state for `batch` slots with C = cache_size
        cache rows per layer (the layout of the module docstring)."""
        if not self.causal:
            raise NotImplementedError(
                "non-causal chunk stepping is not ported (the chunk-layer "
                "kernel takes a causal conv module)")
        if cache_size < 0:
            raise ValueError(f"cache_size {cache_size}: the streaming "
                             "caches have a fixed size >= 0")
        L, d_k = len(self.encoders), self.output_size // self.attention_heads

        def zeros(*shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=device)

        return {"att_cache": zeros(L, batch, self.attention_heads,
                                   cache_size, 2 * d_k),
                "cnn_cache": zeros(L, batch, self.cnn_module_kernel - 1,
                                   self.output_size),
                "offset": zeros(batch, dtype=torch.int32),
                "cache_len": zeros(batch, dtype=torch.int32),
                "wptr": zeros(batch, dtype=torch.int32)}

    def pack_chunk_params(self, cache_size=None, pos_table_len=8192):
        """Per layer: (kernel weights with the serving tensor-core pack,
        chunk_packed_params; position table or None). With
        cache_size, each layer gets its make_chunk_pos_table rows, and the
        chunk step reads every slot's position window from them in place
        of a per-step sinusoid and linear_pos product. Computed once per
        session."""
        with torch.no_grad():
            return [(layer.chunk_packed_params(),
                     None if cache_size is None else make_chunk_pos_table(
                         layer.self_attn.linear_pos.weight, cache_size,
                         pos_table_len))
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
        untouched. → (N, c·k, D); the state advances in place."""
        n_sub = 1
        if xs.dim() == 4:
            n_sub = xs.shape[1]
            xs = xs.reshape((-1,) + tuple(xs.shape[2:]))
        if self.global_cmvn is not None:
            xs = self.global_cmvn(xs)
        # each window subsamples on its own, as sequential steps feed them;
        # the chunk's positions come from the offsets below
        xs = self.embed(xs)[0]
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
            rows = torch.clamp(state["offset"][:, None].long() - C
                               + torch.arange(L, device=dev), min=0)
            pe = sinusoid_position_encoding(rows.reshape(-1),
                                            self.output_size)
            starts = torch.arange(N, dtype=torch.int32, device=dev) * L
        act_i32 = active.to(torch.int32)
        for i, layer in enumerate(self.encoders):
            pos = packed[i][1] if use_table else \
                layer.self_attn.linear_pos(pe)
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

    def forward_chunk(self, xs, state):
        """One streaming chunk of every slot (masr_tpu's forward_chunk):
        exact positions from the offsets, all slots active. xs: (B, T_in,
        F) → (B, c, D); the state advances in place."""
        return self.forward_chunk_batched(xs, state, exact_positions=True)


class ConformerModel(nn.Module):
    """Encoder + CTC head + bidirectional attention decoder, trained with
    the hybrid loss (masr_tpu/models/conformer.py:638-736)."""

    def __init__(self, input_dim, vocab_size, cmvn=None, streaming=True,
                 encoder_conf=None, decoder_conf=None, ctc_weight=0.5,
                 ignore_id=IGNORE_ID, reverse_weight=0.0, lsm_weight=0.0,
                 length_normalized_loss=False):
        super().__init__()
        if not 0.0 <= ctc_weight <= 1.0:
            raise ValueError(f"ctc_weight {ctc_weight} not in [0, 1]")
        self.encoder = self.make_encoder(input_dim, cmvn, streaming,
                                         dict(encoder_conf or {}))
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
            self.lsm_weight, self.length_normalized_loss)
        if r_decoder_out is not None:
            r_loss_att = label_smoothing_loss(
                r_decoder_out, r_ys_out, self.vocab_size, self.ignore_id,
                self.lsm_weight, self.length_normalized_loss)
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

