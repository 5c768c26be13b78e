"""InferencePredictor — owns the model on its device and the stream state
(port of masr_tpu/infer/inference_model.py:21-145, :171-203, :237-310 and
:351-354: full context, and the streaming chunk steps with the host or the
sample-domain fused frontend).

The model is any family of models/registry.py (the Conformer or the
Squeezeformer): it gives `get_encoder_out`, `get_encoder_out_chunk` and
`encoder.init_cache`. Full-context inputs are padded to a multiple of
`length_bucket` frames, as masr_tpu does (there it bounds the compiled
programs; here it keeps the same frames, hence the same padding rows, as
the reference). The stream state is a dict of device tensors that every
chunk step updates in place (the encoder's `init_cache`); the greedy head
(argmax, max prob) runs on the device, so only (B, chunk) ids and probs
come back.
"""
import os

import numpy as np
import torch

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
                 decoding_chunk_size=16, num_decoding_left_chunks=16):
        if not os.path.exists(os.path.join(model_dir, "inference.json")):
            raise FileNotFoundError(
                f"not an inference bundle (no inference.json): {model_dir}")
        self.device = resolve_device(device)
        model, self.meta, self.vocab_list = load_inference_bundle(model_dir)
        self.model = model.to(self.device)
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

    def predict_greedy(self, speech, speech_lengths):
        """Full-context encode with the greedy head on the device: only
        per-frame argmax ids and max probs (B, T') come back."""
        probs, lens = self._encode(speech, speech_lengths)
        return (*greedy_head(probs), lens.cpu().numpy())

    # ------------------------------------------------------------------ #
    def init_stream_state(self, batch=1):
        self.state = self.model.encoder.init_cache(
            batch=batch, cache_size=self.cache_size, device=self.device)

    def _chunk_probs(self, feats):
        """One streaming step of (B, T_win, F) device features → probs."""
        if self.state is None:
            self.init_stream_state(batch=feats.shape[0])
        with torch.no_grad():
            return self.model.get_encoder_out_chunk(feats, self.state)

    def _features(self, x_chunk):
        return torch.as_tensor(np.asarray(x_chunk, np.float32),
                               device=self.device)

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

    def predict_chunk(self, x_chunk):
        """One streaming step. x_chunk: (B, T_win, F) → probs (B, chunk, V)
        ndarray."""
        return self._chunk_probs(self._features(x_chunk)).cpu().numpy()

    def predict_chunk_greedy(self, x_chunk):
        """Streaming step with the greedy head on the device: (B, T_win, F)
        → (ids (B, chunk), max_probs (B, chunk))."""
        return greedy_head(self._chunk_probs(self._features(x_chunk)))

    def predict_chunk_samples(self, samples, gain=1.0, length=None):
        """Fused streaming step: raw samples (B, S_window) float [-1, 1] →
        CTC probs for one chunk, fbank on the device. `length`: valid
        sample count (the rest is padding)."""
        samples = np.asarray(samples, np.float32)
        length = samples.shape[-1] if length is None else length
        return self._chunk_probs(
            self._fused_feats(samples, gain, length)).cpu().numpy()

    def predict_chunk_samples_greedy(self, samples, gain=1.0, length=None):
        """Fused frontend + greedy head: raw samples → (ids, max_probs)."""
        samples = np.asarray(samples, np.float32)
        length = samples.shape[-1] if length is None else length
        return greedy_head(self._chunk_probs(
            self._fused_feats(samples, gain, length)))

    def reset_stream(self):
        self.state = None
