"""MASRPredictor — the public inference API
(port of masr_tpu/infer/predictor.py:20-30, :33-289, :405-600: predict,
predict_batch and predict_stream / reset_stream with the ctc_greedy
decoder, the same streaming window math: window 67, stride 64, feature
cache 3).
"""
import io
import os

import numpy as np

from masr_tpu_torch.audio import AudioSegment
from masr_tpu_torch.data.audio_featurizer import AudioFeaturizer
from masr_tpu_torch.decoders.greedy import GreedyChunkDecoder, _collapse
from masr_tpu_torch.infer.inference_model import InferencePredictor

# streaming constants (masr_tpu/infer/predictor.py:20-26)
DECODING_CHUNK_SIZE = 16
CONTEXT = 7
SUBSAMPLING = 4
CACHED_FEATURE_NUM = CONTEXT - SUBSAMPLING          # 3
DECODING_WINDOW = (DECODING_CHUNK_SIZE - 1) * SUBSAMPLING + CONTEXT  # 67
STRIDE = SUBSAMPLING * DECODING_CHUNK_SIZE          # 64


def _subsampled_len(t):
    return ((t - 1) // 2 - 1) // 2


class MASRPredictor(object):
    def __init__(self, model_dir, decoder="ctc_greedy", warmup=True,
                 device="cuda", num_decoding_left_chunks=16,
                 fused_frontend=True):
        """model_dir: an exported inference bundle directory (masr_tpu's
        export_model.py); device: where the model runs, "cuda" by default
        (raises when CUDA is absent); num_decoding_left_chunks: streaming
        left context in chunks of 16 frames (cache 16 × that); fused_frontend:
        fbank models stream raw samples and make their features on the
        device (False: host fbank, masr_tpu's other path)."""
        if decoder != "ctc_greedy":
            raise NotImplementedError(f"decoder {decoder!r} is not ported "
                                      "yet (the port has ctc_greedy)")
        self.model_dir = model_dir
        self.predictor = InferencePredictor(
            model_dir=model_dir, device=device,
            decoding_chunk_size=DECODING_CHUNK_SIZE,
            num_decoding_left_chunks=num_decoding_left_chunks)
        meta = self.predictor.meta
        self.streaming = meta["streaming"]
        pre = dict(meta.get("preprocess_conf") or {})
        self._audio_featurizer = AudioFeaturizer(train=False, **pre)
        self._vocab_list = self.predictor.vocab_list
        self.fused_frontend = bool(
            fused_frontend and self.streaming
            and pre.get("feature_method", "fbank") == "fbank")
        self.greedy_chunk_decoder = GreedyChunkDecoder(self._vocab_list)
        self.remained_wav = None
        self.cached_feat = None
        self._stream_samples = None         # fused-path raw sample buffer
        if warmup:
            self._warmup()

    def _warmup(self):
        """Random-audio warmup-as-selftest (predict.py:88-93): one second
        of uniform noise from a fixed seed through predict, and half of it
        through the chunk step for streaming models."""
        rng = np.random.default_rng(0)
        audio = rng.uniform(-2e4, 2e4, size=16000).astype(np.float32) / 32768
        self.predict(audio_data=audio, sample_rate=16000)
        if self.streaming:
            self.predict_stream(audio_data=audio[:8000], is_end=True,
                                sample_rate=16000)
            self.reset_stream()

    def _load_audio(self, audio_data, sample_rate=16000):
        """path | bytes | file-like | ndarray → AudioSegment."""
        if isinstance(audio_data, str):
            if not os.path.exists(audio_data):
                raise FileNotFoundError(f"audio file not found: {audio_data}")
            return AudioSegment.from_file(audio_data)
        if isinstance(audio_data, io.BufferedReader):
            return AudioSegment.from_file(audio_data)
        if isinstance(audio_data, np.ndarray):
            return AudioSegment.from_ndarray(audio_data, sample_rate)
        if isinstance(audio_data, bytes):
            return AudioSegment.from_bytes(audio_data)
        raise TypeError(f"unsupported audio_data type: {type(audio_data)}")

    def _results(self, ids, maxp, out_lens):
        results = []
        for i in range(len(out_lens)):
            L = int(out_lens[i])
            score, text = _collapse(ids[i][:L], maxp[i][:L], self._vocab_list)
            results.append({"text": text, "score": score})
        return results

    def predict(self, audio_data, sample_rate=16000):
        """One utterance → {'text', 'score'}."""
        feats = self._audio_featurizer.featurize(
            self._load_audio(audio_data, sample_rate))
        ids, maxp, out_lens = self.predictor.predict_greedy(
            feats[np.newaxis], np.array([feats.shape[0]], np.int64))
        return self._results(ids, maxp, out_lens)[0]

    def featurize_batch(self, audio_list, sample_rate=16000):
        """Utterances → zero-padded features (B, T, F) and lengths (B,)."""
        feats = [self._audio_featurizer.featurize(
            self._load_audio(a, sample_rate)) for a in audio_list]
        T = max(f.shape[0] for f in feats)
        speech = np.zeros((len(feats), T, feats[0].shape[1]), np.float32)
        lens = np.zeros(len(feats), np.int64)
        for i, f in enumerate(feats):
            speech[i, : f.shape[0]] = f
            lens[i] = f.shape[0]
        return speech, lens

    def predict_batch(self, audio_list, sample_rate=16000):
        """Utterances padded into one batch → list of {'text', 'score'}."""
        speech, lens = self.featurize_batch(audio_list, sample_rate)
        return self._results(*self.predictor.predict_greedy(speech, lens))

    # ------------------------------------------------------------------ #
    def _decode_greedy_ids(self, ids, maxp, valid_out):
        if valid_out <= 0:
            return None
        return self.greedy_chunk_decoder.decode_chunk_ids(
            ids[0, :valid_out], maxp[0, :valid_out])

    def _stream_step_host(self, audio_data, is_end):
        """Host-featurize path: fbank over the accumulated remainder on the
        CPU, feature cache windowing, feature windows to the chunk step."""
        if self.remained_wav is None:
            self.remained_wav = audio_data
        else:
            self.remained_wav = AudioSegment(
                np.concatenate([self.remained_wav.samples,
                                audio_data.samples]),
                audio_data.sample_rate)

        x_chunk = self._audio_featurizer.featurize(self.remained_wav)
        x_chunk = np.asarray(x_chunk, np.float32)[np.newaxis]
        if self.cached_feat is None:
            self.cached_feat = x_chunk
        else:
            self.cached_feat = np.concatenate([self.cached_feat, x_chunk],
                                              axis=1)
        hop = int(self.remained_wav.sample_rate * 0.01)
        self.remained_wav = AudioSegment(
            self.remained_wav.samples[hop * x_chunk.shape[1]:],
            self.remained_wav.sample_rate)

        num_frames = self.cached_feat.shape[1]
        if num_frames < DECODING_WINDOW and not is_end:
            return None
        if num_frames < CONTEXT:
            return None
        left_frames = CONTEXT if is_end else DECODING_WINDOW

        score, text, end = None, "", None
        for cur in range(0, num_frames - left_frames + 1, STRIDE):
            end = min(cur + DECODING_WINDOW, num_frames)
            window = self.cached_feat[:, cur:end, :]
            valid_len = window.shape[1]
            if valid_len < DECODING_WINDOW:
                # final partial window: pad to the full window and trim the
                # outputs to the valid frame count
                window = np.pad(window,
                                ((0, 0), (0, DECODING_WINDOW - valid_len),
                                 (0, 0)))
            ids, maxp = self.predictor.predict_chunk_greedy(window)
            r = self._decode_greedy_ids(ids, maxp,
                                        max(_subsampled_len(valid_len), 0))
            if r is not None:
                score, text = r
        if end is not None:
            self.cached_feat = self.cached_feat[:, end - CACHED_FEATURE_NUM:, :]
        return score, text

    def _stream_step_fused(self, audio_data, is_end):
        """Fused device frontend: the sample buffer is windowed in the
        SAMPLE domain and each 67-frame window's fbank runs on the device
        before its chunk step. Kaldi snip-edges frames are pure functions
        of their sample window, so recomputing overlap frames is exact. As
        in masr_tpu, the dB-normalization gain is computed per call over the
        unconsumed buffer and applied to all of the call's windows."""
        sr = self._audio_featurizer.sample_rate
        if audio_data.sample_rate != sr:
            audio_data.resample(sr)
        samples = audio_data.samples
        if self._stream_samples is None:
            self._stream_samples = samples
        else:
            self._stream_samples = np.concatenate(
                [self._stream_samples, samples])
        buf = self._stream_samples

        hop = int(sr * 0.01)
        wlen = int(sr * 0.025)
        num_frames = 0 if len(buf) < wlen else 1 + (len(buf) - wlen) // hop
        if num_frames < DECODING_WINDOW and not is_end:
            return None
        if num_frames < CONTEXT:
            return None
        left_frames = CONTEXT if is_end else DECODING_WINDOW
        window_samples = (DECODING_WINDOW - 1) * hop + wlen

        gain = 1.0
        if self._audio_featurizer._use_dB_normalization:
            ms = float(np.mean(buf.astype(np.float64) ** 2))
            if ms > 0:
                gain_db = self._audio_featurizer._target_dB \
                    - 10.0 * np.log10(ms)
                gain = float(10.0 ** (min(gain_db, 300.0) / 20.0))

        score, text, end = None, "", None
        for cur in range(0, num_frames - left_frames + 1, STRIDE):
            end = min(cur + DECODING_WINDOW, num_frames)
            valid_len = end - cur
            valid_samples = (valid_len - 1) * hop + wlen
            seg = buf[cur * hop: cur * hop + window_samples]
            if len(seg) < window_samples:
                seg = np.pad(seg, (0, window_samples - len(seg)))
            ids, maxp = self.predictor.predict_chunk_samples_greedy(
                seg[None], gain=gain, length=valid_samples)
            r = self._decode_greedy_ids(ids, maxp,
                                        max(_subsampled_len(valid_len), 0))
            if r is not None:
                score, text = r
        if end is not None:
            keep_from = max(end - CACHED_FEATURE_NUM, 0) * hop
            self._stream_samples = buf[keep_from:]
        return score, text

    def predict_stream(self, audio_data, is_end=False, channels=1,
                       samp_width=2, sample_rate=16000):
        """Streaming recognition: feed audio piece by piece (float ndarray
        or PCM bytes); → {'text', 'score'} of the whole stream so far, or
        None until a window is full. Every encoder layer of every window
        runs through the chunk-layer kernel."""
        if not self.streaming:
            raise RuntimeError("the model was not exported as streaming")
        if isinstance(audio_data, np.ndarray):
            audio_data = AudioSegment.from_ndarray(audio_data, sample_rate)
        elif isinstance(audio_data, bytes):
            audio_data = AudioSegment.from_pcm_bytes(
                audio_data, channels=channels, samp_width=samp_width,
                sample_rate=sample_rate)
        else:
            raise TypeError(f"unsupported audio_data type: {type(audio_data)}")
        if self.fused_frontend:
            ret = self._stream_step_fused(audio_data, is_end)
        else:
            ret = self._stream_step_host(audio_data, is_end)
        if ret is None:
            return None
        score, text = ret
        return {"text": text, "score": score}

    def reset_stream(self):
        """Forget the stream: state, buffers and the greedy carry."""
        self.predictor.reset_stream()
        self.remained_wav = None
        self.cached_feat = None
        self._stream_samples = None
        self.greedy_chunk_decoder.reset()
