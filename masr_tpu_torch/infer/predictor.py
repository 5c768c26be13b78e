"""MASRPredictor — the public inference API
(port of masr_tpu/infer/predictor.py: predict, predict_batch, predict_long
(silero VAD segments, recognized in batches), predict_stream /
reset_stream with the same streaming window math: window 67, stride 64,
feature cache 3; punctuation (use_pun) and inverse text normalization
(is_itn) on every path; a bundle by directory or by model_tag).

Decoders, as masr_tpu resolves them (`decoder`, `decoder_configs`):
- ctc_greedy: the argmax head on the device, ids and max probs read back;
- ctc_beam_search: the host prefix beam search (decoders/beam_search.py,
  its native engine unless hotwords or a KenLM binary need the Python one),
  optional n-gram LM; the probs come back to the host;
- attention_rescoring: in predict, its n-best (rescoring_nbest) rescored
  by the attention decoder over the same encode's encoder rows
  (decoders/rescoring.py; rescoring_ctc_weight, rescoring_reverse_weight);
  predict_batch decodes greedily, as masr_tpu's does; streaming, the rows
  of every window are kept on the device and the n-best is rescored at the
  end of the stream (two-pass);
- ctc_beam_search_device: the batched prefix beam search on the device
  (decoders/device_beam.py, beam at most 32), optional dense-bigram fusion
  of an ARPA character LM; streaming, the predictor keeps its state and
  steps it after every chunk on the chunk step's probs, on the device,
  reading back only the best hypothesis.
A beam decoder that cannot be built falls back to greedy with a warning,
as masr_tpu's does; DeepSpeech2, which has no attention decoder, takes
ctc_beam_search for attention_rescoring, with a warning, offline and
streaming (masr_tpu/infer/predictor.py:102-105).

Text post-processing, in masr_tpu's order and conditions: punctuation
(infer/punctuation.py; the rule tier unless pun_model_dir names a plugin
or a transformers checkpoint) on a non-empty result, only at the end of a
stream; then ITN (WeTextProcessing when it imports, else
infer/itn.py's SimpleInverseNormalizer).
"""
import io
import logging
import os

import numpy as np
import torch

from masr_tpu_torch.audio import AudioSegment
from masr_tpu_torch.data.audio_featurizer import AudioFeaturizer
from masr_tpu_torch.decoders.beam_search import BeamSearchDecoder
from masr_tpu_torch.decoders.device_beam import (decode_batch_device,
                                                 device_beam_conf,
                                                 ids_to_text,
                                                 make_stream_decode_fn,
                                                 space_id_of)
from masr_tpu_torch.decoders.greedy import (GreedyChunkDecoder, _collapse,
                                            greedy_decoder)
from masr_tpu_torch.decoders.rescoring import rescore_nbest
from masr_tpu_torch.infer.inference_model import InferencePredictor

logger = logging.getLogger("masr_tpu_torch")

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
    def __init__(self, model_dir=None, model_tag=None, decoder="ctc_greedy",
                 decoder_configs=None, use_pun=False, pun_model_dir=None,
                 num_decoding_left_chunks=16, itn=False, warmup=True,
                 fused_frontend=True, device="cuda"):
        """model_dir: an exported inference bundle directory (the
        exporters of either package), or model_tag: a tag of
        infer/model_zoo.py (in-repo, cached, or downloaded); decoder:
        ctc_greedy, ctc_beam_search, attention_rescoring or
        ctc_beam_search_device, with decoder_configs (BeamSearchDecoder's
        keywords, or the device beam's
        beam_size / cutoff_top_n / alpha / beta / language_model_path, plus
        rescoring_nbest, rescoring_ctc_weight, rescoring_reverse_weight);
        device: where the model runs, "cuda" by default (raises when CUDA
        is absent); num_decoding_left_chunks: streaming left context in
        chunks of 16 frames (cache 16 × that); fused_frontend: fbank models
        stream raw samples and make their features on the device (False:
        host fbank, masr_tpu's other path); use_pun: load the punctuation
        restorer (pun_model_dir: its model, None for the rule tier; each
        call asks for punctuation and ITN with use_pun and is_itn); itn:
        taken as masr_tpu's MASRPredictor takes it, and read by neither
        (each call's is_itn decides)."""
        if model_dir is None:
            if model_tag is None:
                raise ValueError("provide model_dir or model_tag")
            from masr_tpu_torch.infer.model_zoo import get_model_dir
            model_dir = get_model_dir(model_tag)
        if decoder not in ("ctc_greedy", "ctc_beam_search",
                           "attention_rescoring", "ctc_beam_search_device"):
            raise ValueError(f"unknown decoder {decoder!r}")
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
        self.decoder = decoder
        decoder_configs = dict(decoder_configs or {})
        model_conf = meta.get("model_conf") or {}
        self.rescoring_nbest = decoder_configs.pop("rescoring_nbest", 10)
        self.rescoring_ctc_weight = decoder_configs.pop(
            "rescoring_ctc_weight", float(model_conf.get("ctc_weight", 0.3)))
        self.rescoring_reverse_weight = decoder_configs.pop(
            "rescoring_reverse_weight",
            float(model_conf.get("reverse_weight", 0.0))
            if (meta.get("decoder_conf") or {}).get("r_num_blocks", 0) > 0
            else 0.0)
        self.beam_search_decoder = None
        self._device_beam_conf = None
        self._beam_state = None             # streaming device-beam state
        if decoder == "ctc_beam_search_device":
            self._device_beam_conf = device_beam_conf(
                decoder_configs, self._vocab_list, self.predictor.device)
            self._beam_init, self._beam_decode = make_stream_decode_fn(
                **self._device_beam_conf, max_len=4096,
                space_id=space_id_of(self._vocab_list),
                device=self.predictor.device)
        elif decoder in ("ctc_beam_search", "attention_rescoring"):
            try:
                self.beam_search_decoder = BeamSearchDecoder(
                    self._vocab_list, **decoder_configs)
            except Exception as e:
                logger.warning(f"beam search unavailable ({e}); falling "
                               "back to greedy decoding")
                self.decoder = "ctc_greedy"
        if decoder == "attention_rescoring" \
                and not self.predictor.model.has_attention_decoder:
            logger.warning(f"{meta['use_model']} has no attention decoder; "
                           "attention_rescoring falls back to ctc_beam_search")
            self.decoder = "ctc_beam_search"
        self.pun_predictor = None
        if use_pun:
            try:
                from masr_tpu_torch.infer.punctuation import \
                    PunctuationPredictor
                self.pun_predictor = PunctuationPredictor(pun_model_dir)
            except Exception as e:
                logger.warning(f"punctuation model unavailable: {e}")
        self.inv_normalizer = None
        self._vad = None
        self.fused_frontend = bool(
            fused_frontend and self.streaming
            and pre.get("feature_method", "fbank") == "fbank")
        self.greedy_chunk_decoder = GreedyChunkDecoder(self._vocab_list)
        self.remained_wav = None
        self.cached_feat = None
        self._stream_samples = None         # fused-path raw sample buffer
        self._stream_hidden = []            # encoder rows, two-pass streaming
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

    def _greedy_results(self, ids, maxp, out_lens):
        results = []
        for i in range(len(out_lens)):
            L = int(out_lens[i])
            score, text = _collapse(ids[i][:L], maxp[i][:L], self._vocab_list)
            results.append({"text": text, "score": score})
        return results

    def _post(self, result, use_pun, is_itn):
        """Punctuation, then ITN, on a non-empty result's text."""
        text = result["text"]
        if use_pun and text and self.pun_predictor is not None:
            text = self.pun_predictor(text)
        if is_itn and text:
            text = self.inverse_text_normalization(text)
        return {"text": text, "score": result["score"]}

    def _rescoring(self, speech, lens):
        """CTC prefix beam n-best → attention-decoder rescoring, per
        utterance of the batch: total = att + rescoring_ctc_weight · ctc
        (masr_tpu/infer/predictor.py:219-242)."""
        enc, probs, out_lens = self.predictor.encode_for_rescoring(speech,
                                                                   lens)
        results = []
        for i in range(len(out_lens)):
            nbest = self.beam_search_decoder.decode_nbest(
                probs[i][: int(out_lens[i])], self.rescoring_nbest)
            results.append(self._pick_rescored(enc[i:i + 1], out_lens[i],
                                               nbest)
                           or {"text": "", "score": 0.0})
        return results

    def _pick_rescored(self, enc, enc_len, nbest):
        """The n-best rescored over the encoder rows enc (1, T, D) →
        {'text', 'score'} of the best, or None when every hypothesis is
        empty."""
        best = rescore_nbest(self.predictor.model, enc, enc_len, nbest,
                             self.rescoring_ctc_weight,
                             self.rescoring_reverse_weight,
                             self.rescoring_nbest)
        if best is None:
            return None
        return {"text": ids_to_text(best[1], self._vocab_list),
                "score": best[0]}

    def _decode_batch(self, speech, lens):
        """(B, T, F) features → a list of {'text', 'score'} with the
        configured decoder; under attention_rescoring each utterance's CTC
        probs decode greedily, as masr_tpu's predict_batch decodes them."""
        if self._device_beam_conf is not None:
            # probs stay on the device from the encode to the beam's end
            probs, out_lens = self.predictor.predict_device(speech, lens)
            return [{"text": text, "score": score}
                    for score, text in decode_batch_device(
                        probs, out_lens, self._vocab_list,
                        **self._device_beam_conf)]
        if self.decoder == "ctc_beam_search":
            probs, out_lens = self.predictor.predict(speech, lens)
            return [{"text": text, "score": score} for score, text in
                    self.beam_search_decoder.decode_batch_beam_search_offline(
                        [probs[i][: int(out_lens[i])]
                         for i in range(len(out_lens))])]
        if self.decoder == "attention_rescoring":
            probs, out_lens = self.predictor.predict(speech, lens)
            results = []
            for i in range(len(out_lens)):
                score, text = greedy_decoder(probs[i][: int(out_lens[i])],
                                             self._vocab_list)
                results.append({"text": text, "score": score})
            return results
        return self._greedy_results(*self.predictor.predict_greedy(speech,
                                                                   lens))

    def predict(self, audio_data, use_pun=False, is_itn=False,
                sample_rate=16000):
        """One utterance → {'text', 'score'}."""
        feats = self._audio_featurizer.featurize(
            self._load_audio(audio_data, sample_rate))
        speech = feats[np.newaxis]
        lens = np.array([feats.shape[0]], np.int64)
        if self.decoder == "attention_rescoring":
            result = self._rescoring(speech, lens)[0]
        else:
            result = self._decode_batch(speech, lens)[0]
        return self._post(result, use_pun, is_itn)

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

    def predict_batch(self, audio_list, use_pun=False, is_itn=False,
                      sample_rate=16000):
        """Utterances padded into one batch → list of {'text', 'score'}
        (attention_rescoring decodes greedily here, as in masr_tpu)."""
        return [self._post(r, use_pun, is_itn) for r in self._decode_batch(
            *self.featurize_batch(audio_list, sample_rate))]

    # ------------------------------------------------------------------ #
    def predict_long(self, audio_data, use_pun=False, is_itn=False,
                     sample_rate=16000):
        """Long audio: the silero VAD's speech segments (infer/vad.py, on
        the host), recognized in batches → {'text': the segments' texts
        joined by '，', 'score': their mean score rounded to 2 places}."""
        if self._vad is None:
            from masr_tpu_torch.infer.vad import VADPredictor
            self._vad = VADPredictor()
        audio_segment = self._load_audio(audio_data, sample_rate)
        if audio_segment.sample_rate != self._audio_featurizer.sample_rate:
            audio_segment.resample(self._audio_featurizer.sample_rate)
        samples = audio_segment.samples
        sr = audio_segment.sample_rate
        speech_ts = self._vad.get_speech_timestamps(samples, sr)
        segs = [samples[ts["start"]: ts["end"]] for ts in speech_ts]
        texts, scores = "", []
        for result in self._predict_segments(segs, use_pun, is_itn, sr):
            if result["text"]:
                texts = texts + "，" + result["text"] if texts \
                    else result["text"]
                scores.append(result["score"])
        return {"text": texts,
                "score": round(float(np.mean(scores)), 2) if scores else 0.0}

    def _predict_segments(self, segs, use_pun, is_itn, sr, group=16):
        """The segments sorted by length and recognized `group` at a time
        through predict_batch, results in the segments' order; attention
        rescoring (per utterance) takes predict per segment. masr_tpu pads
        the last group to `group` with copies of its shortest segment, so
        that XLA reuses one program; here the group runs as it is (the
        padded length is the group's longest either way)."""
        if self.decoder == "attention_rescoring" or len(segs) <= 1:
            return [self.predict(s, use_pun=use_pun, is_itn=is_itn,
                                 sample_rate=sr) for s in segs]
        order = sorted(range(len(segs)), key=lambda i: len(segs[i]))
        results = [None] * len(segs)
        for g in range(0, len(order), group):
            idx = order[g: g + group]
            decoded = self.predict_batch([segs[i] for i in idx],
                                         use_pun=use_pun, is_itn=is_itn,
                                         sample_rate=sr)
            for i, r in zip(idx, decoded):
                results[i] = r
        return results

    # ------------------------------------------------------------------ #
    def _window(self, valid_out, window=None, seg=None, gain=1.0,
                valid_samples=None):
        """One streaming window through the chunk step (feature `window`,
        or raw samples `seg` with the fused frontend) and the configured
        decoder → (score, text) of the stream so far, or None when the
        window has no valid output frame."""
        ip = self.predictor
        if self.beam_search_decoder is None and self._device_beam_conf is None:
            ids, maxp = ip.predict_chunk_greedy(window) if window is not None \
                else ip.predict_chunk_samples_greedy(seg, gain=gain,
                                                     length=valid_samples)
            if valid_out <= 0:
                return None
            return self.greedy_chunk_decoder.decode_chunk_ids(
                ids[0, :valid_out], maxp[0, :valid_out])
        rescoring = self.decoder == "attention_rescoring"
        out = ip.chunk_step(window, seg, gain, valid_samples, full=rescoring)
        probs = out[0] if rescoring else out
        if self._device_beam_conf is not None:
            # the beams step on the device probs; padded frames (and a
            # window without valid frames) leave them untouched
            if self._beam_state is None:
                self._beam_state = self._beam_init(1)
            fv = torch.arange(probs.shape[1], device=probs.device)[None] \
                < valid_out
            self._beam_state, best = self._beam_decode(self._beam_state,
                                                       probs, fv)
            if valid_out <= 0:
                return None
            tokens, length, score = (x[0].cpu().numpy() for x in best)
            return float(score), ids_to_text(tokens[: int(length)],
                                             self._vocab_list)
        if valid_out <= 0:
            return None
        if rescoring:
            # the window's encoder rows stay on the device for the
            # end-of-stream rescoring
            self._stream_hidden.append(out[1][:, :valid_out])
        return self.beam_search_decoder.decode_chunk(
            probs[0, :valid_out].cpu().numpy())

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
            r = self._window(max(_subsampled_len(valid_len), 0),
                             window=window)
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
            r = self._window(max(_subsampled_len(valid_len), 0),
                             seg=seg[None], gain=gain,
                             valid_samples=valid_samples)
            if r is not None:
                score, text = r
        if end is not None:
            keep_from = max(end - CACHED_FEATURE_NUM, 0) * hop
            self._stream_samples = buf[keep_from:]
        return score, text

    def predict_stream(self, audio_data, is_end=False, use_pun=False,
                       is_itn=False, channels=1, samp_width=2,
                       sample_rate=16000):
        """Streaming recognition: feed audio piece by piece (float ndarray
        or PCM bytes); → {'text', 'score'} of the whole stream so far, or
        None until a window is full. Every encoder layer of every window
        runs through the chunk-layer kernel. With attention_rescoring, the
        result of the call with is_end is the stream's n-best rescored by
        the attention decoder over every window's encoder rows.
        Punctuation applies only with is_end, ITN to every result."""
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
        # two-pass: rerank the CTC n-best with the attention decoder over
        # the accumulated encoder rows (masr_tpu/infer/predictor.py:567-583)
        if is_end and self.decoder == "attention_rescoring" \
                and self.beam_search_decoder is not None \
                and self._stream_hidden:
            enc = torch.cat(self._stream_hidden, dim=1)
            best = self._pick_rescored(
                enc, enc.shape[1],
                self.beam_search_decoder.nbest_state(self.rescoring_nbest))
            if best is not None:
                text, score = best["text"], best["score"]
        return self._post({"text": text, "score": score},
                          use_pun and is_end, is_itn)

    def reset_stream(self):
        """Forget the stream: state, buffers, the kept encoder rows and the
        decoders' carry."""
        self.predictor.reset_stream()
        self.remained_wav = None
        self.cached_feat = None
        self._stream_samples = None
        self._stream_hidden = []
        self._beam_state = None
        self.greedy_chunk_decoder.reset()
        if self.beam_search_decoder is not None:
            self.beam_search_decoder.reset_state()

    def inverse_text_normalization(self, text):
        """Chinese ITN: WeTextProcessing's InverseNormalizer when it
        imports, else the in-repo SimpleInverseNormalizer."""
        if self.inv_normalizer is None:
            try:
                from itn.chinese.inverse_normalizer import InverseNormalizer
                self.inv_normalizer = InverseNormalizer()
            except ImportError:
                from masr_tpu_torch.infer.itn import SimpleInverseNormalizer
                self.inv_normalizer = SimpleInverseNormalizer()
        return self.inv_normalizer.normalize(text)
