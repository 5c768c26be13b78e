"""DeepSpeech2 (CRNN) model (port of masr_tpu/models/deepspeech2.py).

Conv2dSubsampling4Pure → N × (LSTM | GRU, forward or bidirectional, then
LayerNorm) → CTC head. The streaming state is the per-layer (h, c) stacks
(L, B, H), carried from window to window by `get_encoder_out_chunk`.

The recurrence is no Pallas kernel in masr_tpu (a lax.scan on XLA with the
input projection hoisted out of it), so the port runs it through
torch.nn.LSTM / torch.nn.GRU: cuDNN on the card, PyTorch's own loop on the
CPU. Lengths go through pack_padded_sequence, which gives what flax's
seq_lengths gives: the backward direction reverses each utterance's valid
prefix, and the final carry is the one at len − 1. Frames past a length
differ: packed outputs are 0 there, masr_tpu's scan leaves values there
that no valid frame reads. The chunk steps feed whole windows (every
length = T) and skip the packing.

The encoder runs in full f32: its forward turns cuDNN's TF32 off
(torch.backends.cudnn.allow_tf32, which governs the RNNs and the
convolutions) and puts the flag back as it found it when it returns, so
that no other model in the process sees it change; with TF32, 5 layers of
1024 units over ~300 steps drift past the card-vs-CPU tolerance. The
backward pass runs after the forward has returned, under the caller's
setting: the trainer turns TF32 off for the whole run.

bf16 serving (build_model(..., dtype=torch.bfloat16), masr_tpu's
dtype=bf16): the parameters stay f32; the features are cast to
`compute_dtype` after CMVN; the convs, the recurrence (bf16 copies of its
weights, kept per layer while they stay as they are), the LayerNorms and
the head's product compute in bf16, the streaming h and c are bf16, and
the CTC probabilities leave in f32. masr_tpu's cells are XLA ops that
round h, c and every gate to bf16 after each op
(masr_tpu/models/deepspeech2.py:68-120); torch's bf16 recurrence (cuDNN's
on the card, PyTorch's loop on the CPU) rounds at other points, so the two
part by a few bf16 roundings that the recurrence carries from step to step
(the tests measure it). TF32 has no meaning at bf16: the bf16 encoder
leaves cuDNN's flags as the caller set them. Training stays f32.

Module names follow upstream MASR (encoder.conv.conv.{0,2},
encoder.rnns.{i}.rnn.weight_ih_l0[_reverse], encoder.rnns.{i}.layer_norm,
ctc.ctc_lo); models/weights.py maps them to and from masr_tpu's flax tree.
"""
import contextlib

import torch
from torch import nn
from torch.nn.utils.rnn import pack_padded_sequence, pad_packed_sequence

from masr_tpu_torch.models.layers import LayerNorm, compute_weight
from masr_tpu_torch.models.losses import CTCHead
from masr_tpu_torch.models.subsampling import subsampling_class


@contextlib.contextmanager
def _cudnn_full_f32():
    """cuDNN's TF32 off inside the block, the caller's setting after it."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def _frozen_head(n):
    """A grad hook that zeroes the first n entries of a bias's grad."""
    def hook(grad):
        grad = grad.clone()
        grad[:n] = 0
        return grad
    return hook


class RNNLayer(nn.Module):
    """One LSTM or GRU layer (forward, or bidirectional with the outputs
    concatenated) and a LayerNorm (flax's epsilon 1e-6).

    torch's cells carry two biases where flax's carry one: an LSTM's
    bias_ih and a GRU's b_hr and b_hz have no flax counterpart (the weight
    map holds them at 0 and adds them in going back). Their grads are
    zeroed, so that they stay where they are and a train step moves each
    gate's bias as masr_tpu's step moves its single one, not twice."""

    def __init__(self, input_size, rnn_size, bidirectional=False,
                 use_gru=False):
        super().__init__()
        cls = nn.GRU if use_gru else nn.LSTM
        self.rnn = cls(input_size, rnn_size, batch_first=True,
                       bidirectional=bidirectional)
        for rev in ("", "_reverse")[:1 + bidirectional]:
            if use_gru:
                getattr(self.rnn, "bias_hh_l0" + rev).register_hook(
                    _frozen_head(2 * rnn_size))
            else:
                getattr(self.rnn, "bias_ih_l0" + rev).register_hook(
                    _frozen_head(4 * rnn_size))
        self.layer_norm = LayerNorm(rnn_size * (1 + bidirectional),
                                    eps=1e-6)
        self.use_gru = use_gru
        self.bidirectional = bidirectional
        self.rnn_size = rnn_size

    def forward(self, x, x_lens=None, h0=None, c0=None):
        """x (B, T, D); x_lens (B,) valid frames, or None when every frame
        is valid; h0, c0 (B, H) the forward direction's initial carry (the
        backward one starts at 0) → (y (B, T, H·dirs), final h, final c
        (zeros for a GRU), both (B, H) of the forward direction), in x's
        dtype: a bf16 x runs the recurrence on bf16 copies of the weights
        (compute_weight)."""
        B, T, _ = x.shape
        zero = x.new_zeros((B, self.rnn_size))
        h0 = zero if h0 is None else h0
        c0 = zero if c0 is None else c0
        hx = torch.stack([h0, zero] if self.bidirectional else [h0])
        if not self.use_gru:
            hx = (hx, torch.stack([c0, zero] if self.bidirectional
                                  else [c0]))
        if x_lens is None:
            y, hn = self._rnn(x, hx)
        else:
            # an utterance of 0 frames keeps its initial carry (below)
            lens = x_lens.detach().to("cpu", torch.int64)
            packed = pack_padded_sequence(x, lens.clamp(min=1),
                                          batch_first=True,
                                          enforce_sorted=False)
            y, hn = self._rnn(packed, hx)
            y, _ = pad_packed_sequence(y, batch_first=True, total_length=T)
        if self.use_gru:
            hT, cT = hn[0], torch.zeros_like(hn[0])
        else:
            hT, cT = hn[0][0], hn[1][0]
        if x_lens is not None:
            empty = (x_lens <= 0)[:, None]
            hT = torch.where(empty, h0, hT)
            if not self.use_gru:
                cT = torch.where(empty, c0, cT)
        return self.layer_norm(y), hT, cT

    def _rnn(self, x, hx):
        """self.rnn in the dtype of x (a tensor or a PackedSequence): bf16
        through torch.func.functional_call with the bf16 copies of its
        parameters, any other dtype as it is."""
        data = x.data if isinstance(x, nn.utils.rnn.PackedSequence) else x
        if data.dtype != torch.bfloat16:
            return self.rnn(x, hx)
        params = {name: compute_weight(self.rnn, data.dtype, name=name)
                  for name, _ in self.rnn.named_parameters()}
        return torch.func.functional_call(self.rnn, params, (x, hx))


class CRNNEncoder(nn.Module):
    """CMVN → Conv2dSubsampling4Pure (32 channels) → num_rnn_layers
    RNNLayers. fast_scan and scan_unroll (masr_tpu's scan options) are
    accepted and have no counterpart here.

    Its streaming interface is the attention encoders' (init_cache,
    pack_chunk_params, multi_chunk, position_tables), so that the predictor
    and the engine serve every family alike: the state is the h/c carry,
    and there are no weight packs, multi-chunk ticks or position tables."""

    multi_chunk = False
    position_tables = False

    def __init__(self, input_dim, num_rnn_layers=5, rnn_size=1024,
                 rnn_direction="forward", use_gru=False, cmvn=None,
                 fast_scan=True, scan_unroll=1, dtype=torch.float32):
        super().__init__()
        self.global_cmvn = cmvn
        self.compute_dtype = dtype
        self.conv = subsampling_class("conv2d", "deepspeech2")(input_dim, 32)
        bidirectional = rnn_direction in ("bidirect", "bidirectional")
        sizes = [self.conv.output_dim] + \
            [rnn_size * (1 + bidirectional)] * (num_rnn_layers - 1)
        self.rnns = nn.ModuleList(
            RNNLayer(d, rnn_size, bidirectional, use_gru) for d in sizes)
        self.num_rnn_layers = num_rnn_layers
        self.rnn_size = rnn_size
        self.output_size = rnn_size * (1 + bidirectional)

    def forward(self, x, x_lens=None, init_state_h=None, init_state_c=None):
        """x (B, T, F) features, x_lens (B,) or None (every frame valid),
        initial (L, B, H) h and c stacks or None → (out (B, T', D),
        out_lens or None, h stack, c stack), in the compute dtype."""
        f32 = self.compute_dtype == torch.float32
        with _cudnn_full_f32() if f32 else contextlib.nullcontext():
            if self.global_cmvn is not None:
                x = self.global_cmvn(x)
            x, x_lens = self.conv(x.to(self.compute_dtype), x_lens)
            hs, cs = [], []
            for i, rnn in enumerate(self.rnns):
                x, hT, cT = rnn(
                    x, x_lens,
                    None if init_state_h is None else init_state_h[i],
                    None if init_state_c is None else init_state_c[i])
                hs.append(hT)
                cs.append(cT)
        return x, x_lens, torch.stack(hs), torch.stack(cs)

    def init_cache(self, batch=1, cache_size=None, device=None):
        """Zero h and c stacks (L, batch, H) in the compute dtype, as
        masr_tpu keeps them; the carry has no cache rows, so cache_size is
        unused."""
        shape = (self.num_rnn_layers, batch, self.rnn_size)
        return {"h": torch.zeros(shape, dtype=self.compute_dtype,
                                 device=device),
                "c": torch.zeros(shape, dtype=self.compute_dtype,
                                 device=device)}

    def pack_chunk_params(self, cache_size=None, pos_table_len=8192):
        """No chunk kernel steps this family: nothing to pack."""
        return None


class DeepSpeech2Model(nn.Module):
    """The CRNN encoder and the CTC head; its loss is the CTC loss alone
    (row 4's kernel on the card). decoder_conf ({} in
    configs/deepspeech2.yml; masr_tpu hands it to the head, whose dropout no
    config sets) and model_conf (the attention families' loss weights,
    which masr_tpu's registry does not pass) are accepted and unused.
    With no attention decoder, attention_rescoring falls back to
    ctc_beam_search in the predictor and the trainer's eval."""

    has_attention_decoder = False

    def __init__(self, input_dim, vocab_size, cmvn=None, streaming=True,
                 encoder_conf=None, decoder_conf=None, dtype=torch.float32,
                 **model_conf):
        super().__init__()
        self.encoder = CRNNEncoder(
            input_dim, cmvn=cmvn,
            rnn_direction="forward" if streaming else "bidirect",
            dtype=dtype, **dict(encoder_conf or {}))
        self.ctc = CTCHead(self.encoder.output_size, vocab_size)

    def forward(self, speech, speech_lengths, text, text_lengths,
                generator=None, chunk_generator=None):
        """→ {loss, loss_att (0), loss_ctc, acc_att (0)}; the model draws no
        randomness, so the generators are unused. f32 only."""
        if self.encoder.compute_dtype != torch.float32:
            raise NotImplementedError(
                "bf16 training (enable_amp) is not ported yet: ROADMAP "
                "queue 1, item 2")
        eouts, eouts_len, _, _ = self.encoder(speech, speech_lengths)
        loss = self.ctc(eouts, eouts_len, text, text_lengths)
        zero = loss.new_zeros(())
        return {"loss": loss, "loss_att": zero, "loss_ctc": loss,
                "acc_att": zero}

    def get_encoder_out(self, speech, speech_lengths):
        """→ (CTC probs (B, T', V), lengths (B,))."""
        eouts, lens, _, _ = self.encoder(speech, speech_lengths)
        return self.ctc.softmax(eouts), lens

    def get_encoder_out_chunk(self, speech, state):
        """One streaming window: speech (B, T, F), every frame valid (the
        conv's 3 frames of overlap come from the window, not a cache);
        state {'h', 'c'} (L, B, H), updated in place → CTC probs."""
        eouts, _, h, c = self.encoder(speech, None, state["h"], state["c"])
        state["h"].copy_(h)
        state["c"].copy_(c)
        return self.ctc.softmax(eouts)

    def get_encoder_out_chunk_batched(self, speech, states, packed=None,
                                      active=None, exact=False):
        """The engine's step: every slot of speech (N, T, F) in one call;
        only `active` slots (N,) bool take their new h/c, the others keep
        theirs (masr_tpu/infer/batch_stream.py:155-160). packed and exact
        (the attention encoders' weight packs and positions route) have no
        counterpart here. → CTC probs (N, T', V)."""
        eouts, _, h, c = self.encoder(speech, None, states["h"], states["c"])
        if active is None:
            states["h"].copy_(h)
            states["c"].copy_(c)
        else:
            keep = active.view(1, -1, 1)
            states["h"].copy_(torch.where(keep, h, states["h"]))
            states["c"].copy_(torch.where(keep, c, states["c"]))
        return self.ctc.softmax(eouts)

    def init_cache(self, batch=1, device=None):
        """The streaming state: zero h and c stacks (L, batch, H)."""
        return self.encoder.init_cache(batch=batch, device=device)

    def ctc_logits(self, encoder_out):
        return self.ctc.logits(encoder_out)
