"""InferencePredictor — owns the model on its device and the stream state
(port of masr_tpu/infer/inference_model.py:21-145, :171-310 and :312-354:
full context, attention rescoring, and the streaming chunk steps with the
host or the sample-domain fused frontend, with the rescoring rows).

The model is any family of models/registry.py (the Conformer, the
Squeezeformer, the Efficient-Conformer, whose chunk of 16 frames emits
8, or DeepSpeech2): it gives `get_encoder_out` and `get_encoder_out_chunk`;
the stream state is `encoder.init_cache`, or for DeepSpeech2 the model's
`init_cache`, its (L, B, H) h and c stacks (masr_tpu/infer/
inference_model.py:237-245). Full-context inputs are padded to a multiple of
`length_bucket` frames, as masr_tpu does (there it bounds the compiled
programs; here it keeps the same frames, hence the same padding rows, as
the reference). The stream state is a dict of device tensors that every
chunk step updates in place (the encoder's `init_cache`); the greedy head
(argmax, max prob) runs on the device, so only (B, chunk) ids and probs
come back; `chunk_step` leaves the probs (and for rescoring the encoder's
rows) on the device for a decoder that runs there. Every device call
runs under its own torch.no_grad(): grad mode is per thread, and a server
calls the predictor from threads of its own.

dtype (masr_tpu's InferencePredictor(dtype=)): the compute dtype, None for
f32, or torch.bfloat16 for every family (load_inference_bundle's dtype).
In bf16 the offline encode, attention rescoring, the chunk steps and the
fused frontend's encoder run in bf16; the features (and the fused
frontend's fbank) stay f32 up to the encoder's CMVN, the stream state is
bf16, and the probabilities come back f32.
"""
import os

import numpy as np
import torch

from masr_tpu_torch.decoders.rescoring import attention_scores
from masr_tpu_torch.infer.bundle import load_inference_bundle


def _round_up(n, m):
    return -(-n // m) * m


def resolve_device(device):
    """→ torch.device; a CUDA device without CUDA raises (no silent CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not "
                           "available")
    return device


def greedy_head(probs):
    """(B, T, V) probs on the device → (ids (B, T) int32, max probs (B, T))
    as numpy."""
    maxp, ids = probs.max(dim=-1)
    return ids.to(torch.int32).cpu().numpy(), maxp.cpu().numpy()


class InferencePredictor(object):
    def __init__(self, model_dir, length_bucket=200, device="cuda",
                 decoding_chunk_size=16, num_decoding_left_chunks=16,
                 dtype=None):
        if not os.path.exists(os.path.join(model_dir, "inference.json")):
            raise FileNotFoundError(
                f"not an inference bundle (no inference.json): {model_dir}")
        self.device = resolve_device(device)
        self.dtype = dtype or torch.float32
        model, self.meta, self.vocab_list = load_inference_bundle(
            model_dir, self.dtype)
        self.model = model.to(self.device)
        self.use_model = self.meta["use_model"]
        self.length_bucket = length_bucket
        self.decoding_chunk_size = decoding_chunk_size
        self.num_decoding_left_chunks = num_decoding_left_chunks
        self.cache_size = decoding_chunk_size * num_decoding_left_chunks
        self.state = None                   # streaming state (device dict)

    def _encode(self, speech, speech_lengths):
        speech = np.asarray(speech, np.float32)
        B, T, F = speech.shape
        T_pad = _round_up(max(T, 8), self.length_bucket)
        if T_pad != T:
            speech = np.pad(speech, ((0, 0), (0, T_pad - T), (0, 0)))
        with torch.no_grad():
            return self.model.get_encoder_out(
                torch.from_numpy(speech).to(self.device),
                torch.as_tensor(np.asarray(speech_lengths),
                                device=self.device))

    def predict(self, speech, speech_lengths):
        """Full-context CTC probs. speech: (B, T, F) ndarray →
        (probs (B, T', V) ndarray, out_lens (B,))."""
        probs, lens = self._encode(speech, speech_lengths)
        return probs.cpu().numpy(), lens.cpu().numpy()

    def predict_device(self, speech, speech_lengths):
        """Like predict, but the probs and lengths stay on the device, for
        a decoder that runs there (decoders/device_beam.py)."""
        return self._encode(speech, speech_lengths)

    def predict_greedy(self, speech, speech_lengths):
        """Full-context encode with the greedy head on the device: only
        per-frame argmax ids and max probs (B, T') come back."""
        probs, lens = self._encode(speech, speech_lengths)
        return (*greedy_head(probs), lens.cpu().numpy())

    # ------------------------------------------------------------------ #
    def encode_for_rescoring(self, speech, speech_lengths):
        """The full-context encode → (encoder_out (B, T', D) on the device,
        probs (B, T', V) ndarray, out_lens (B,) ndarray)."""
        speech = np.asarray(speech, np.float32)
        B, T, F = speech.shape
        T_pad = _round_up(max(T, 8), self.length_bucket)
        if T_pad != T:
            speech = np.pad(speech, ((0, 0), (0, T_pad - T), (0, 0)))
        with torch.no_grad():
            enc, probs, lens = self.model.encode_for_rescoring(
                torch.from_numpy(speech).to(self.device),
                torch.as_tensor(np.asarray(speech_lengths),
                                device=self.device))
        return enc, probs.cpu().numpy(), lens.cpu().numpy()

    def rescore(self, encoder_out, encoder_len, hyps_list, reverse_weight=0.0,
                nbest_pad=10, len_bucket=8):
        """Attention scores of the hypotheses (lists of token ids) over one
        utterance's encoder rows (1, T, D) → (N,) ndarray. As masr_tpu, the
        hypotheses are padded to nbest_pad rows of a length rounded up to
        len_bucket (decoders/rescoring.py) and only the first nbest_pad are
        scored."""
        enc = torch.as_tensor(encoder_out, dtype=self.dtype,
                              device=self.device)
        return attention_scores(self.model, enc, encoder_len, hyps_list,
                                reverse_weight, nbest_pad, len_bucket)

    # ------------------------------------------------------------------ #
    def init_stream_state(self, batch=1):
        self.state = self.model.encoder.init_cache(
            batch=batch, cache_size=self.cache_size, device=self.device)

    def _features(self, x_chunk):
        return torch.as_tensor(np.asarray(x_chunk, np.float32),
                               device=self.device)

    @torch.no_grad()
    def _fused_feats(self, samples, gain, length):
        """samples (B, S) float [-1, 1] → fbank features on the device, as
        the host path makes them: dB-norm gain → int16 scale with
        truncation → Kaldi fbank; frames past `length` samples are zeroed
        like the host's feature zero-pad."""
        from masr_tpu_torch.ops.fbank import fbank_torch
        pre = self.meta.get("preprocess_conf") or {}
        wav = torch.as_tensor(np.asarray(samples, np.float32),
                              device=self.device)
        if wav.dim() == 1:
            wav = wav[None]
        wav = torch.trunc(torch.clamp(
            wav * float(np.float32(gain)) * 32768.0, -32768.0, 32767.0))
        feats, _ = fbank_torch(
            wav, lengths=torch.full((wav.shape[0],), int(length),
                                    dtype=torch.int32, device=self.device),
            num_mel_bins=int(pre.get("n_mels", 80)),
            sample_rate=int(pre.get("sample_rate", 16000)))
        return feats

    def chunk_step(self, x_chunk=None, samples=None, gain=1.0, length=None,
                   full=False):
        """One streaming step on the device, from feature windows x_chunk
        (B, T_win, F), or with the fused frontend from raw samples
        (B, S_window) float [-1, 1] (`length` valid samples, the rest
        padding; fbank on the device) → CTC probs (B, chunk, V) on the
        device; full=True → (probs, the encoder's output rows (B, chunk,
        D)), for attention rescoring."""
        if x_chunk is not None:
            feats = self._features(x_chunk)
        else:
            samples = np.asarray(samples, np.float32)
            feats = self._fused_feats(
                samples, gain, samples.shape[-1] if length is None
                else length)
        if self.state is None:
            self.init_stream_state(batch=feats.shape[0])
        with torch.no_grad():
            if full:
                return self.model.get_encoder_out_chunk_full(feats,
                                                             self.state)
            return self.model.get_encoder_out_chunk(feats, self.state)

    def predict_chunk(self, x_chunk):
        """One streaming step. x_chunk: (B, T_win, F) → probs (B, chunk, V)
        ndarray."""
        return self.chunk_step(x_chunk).cpu().numpy()

    def predict_chunk_full(self, x_chunk):
        """Streaming step that also returns the encoder's output rows
        (B, chunk, D), left on the device, for end-of-stream attention
        rescoring → (probs ndarray, hidden)."""
        probs, hidden = self.chunk_step(x_chunk, full=True)
        return probs.cpu().numpy(), hidden

    def predict_chunk_greedy(self, x_chunk):
        """Streaming step with the greedy head on the device: (B, T_win, F)
        → (ids (B, chunk), max_probs (B, chunk))."""
        return greedy_head(self.chunk_step(x_chunk))

    def predict_chunk_samples(self, samples, gain=1.0, length=None):
        """Fused streaming step: raw samples (B, S_window) float [-1, 1] →
        CTC probs for one chunk, fbank on the device. `length`: valid
        sample count (the rest is padding)."""
        return self.chunk_step(samples=samples, gain=gain,
                               length=length).cpu().numpy()

    def predict_chunk_samples_greedy(self, samples, gain=1.0, length=None):
        """Fused frontend + greedy head: raw samples → (ids, max_probs)."""
        return greedy_head(self.chunk_step(samples=samples, gain=gain,
                                           length=length))

    def reset_stream(self):
        self.state = None
