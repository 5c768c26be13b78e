"""Batched streaming sessions: serve N concurrent audio streams with ONE
chunk step per tick (port of masr_tpu/infer/batch_stream.py, with the
ctc_greedy and the ctc_beam_search_device decoders).

Every tick runs all N slots through the encoder's batched chunk step
(`forward_chunk_batched` of models/conformer.py, models/squeezeformer.py or
models/efficient_conformer.py), whose layers each launch the family's
chunk-layer kernel once, or, in an encoder without one (the
Efficient-Conformer, a non-causal model), run eagerly. Slots
advance selectively, so streams start and stop independently. Host-side
feature windowing and the greedy carry are per slot, identical to
MASRPredictor.predict_stream. With ctc_beam_search_device every dispatch
steps all slots' prefix beams (decoders/device_beam.py) on the dispatch's
probs on the device, slots without valid frames untouched, and reads back
each slot's best hypothesis; open/close give a slot a fresh beam.

State lives on the device as tensors (the encoder's `init_cache` at N
slots) and is updated in place: the kernel writes the fresh K/V rows and
the cnn cache only for active slots, and only their offsets, cache lengths
and ring pointers advance. masr_tpu's buffer donation and where()-merge of
the new state have no counterpart here; inactive slots are simply left
untouched. An encoder with `position_tables` (the causal Conformer) reads
its positions from per-layer tables until a slot passes their horizon; one
without computes them at every step, so every slot of a tick goes through
one dispatch. Multi-chunk ticks need an encoder with `multi_chunk`.

DeepSpeech2's slots hold (L, N, H) h and c stacks (the model's
`init_cache`, masr_tpu/infer/batch_stream.py:102-104): a dispatch runs
every slot's window through the recurrence in one call and only the active
slots take their new carry; a closed slot's carry is zeroed.
"""
import numpy as np
import torch

from masr_tpu_torch.data.audio_featurizer import AudioFeaturizer
from masr_tpu_torch.decoders.device_beam import (device_beam_conf,
                                                 ids_to_text,
                                                 make_stream_decode_fn,
                                                 space_id_of)
from masr_tpu_torch.decoders.greedy import GreedyChunkDecoder
from masr_tpu_torch.infer.inference_model import greedy_head
from masr_tpu_torch.infer.predictor import (CACHED_FEATURE_NUM, CONTEXT,
                                            DECODING_CHUNK_SIZE,
                                            DECODING_WINDOW, STRIDE,
                                            _subsampled_len)


class BatchStreamSession(object):
    def __init__(self, inference_predictor, vocab_list, preprocess_conf=None,
                 max_streams=8, decoder="ctc_greedy", decoder_conf=None,
                 tick_chunks=1, pos_table_len=8192):
        """inference_predictor: the InferencePredictor whose model serves
        the slots. decoder: 'ctc_greedy' (the argmax head, a host carry per
        slot) or 'ctc_beam_search_device' (every slot's prefix beam search
        on the device after each dispatch), with decoder_conf: beam_size
        (at most 32), cutoff_top_n, max_len (tokens a slot's beam keeps,
        512), lm_table (build_dense_bigram's table), alpha, beta.
        tick_chunks=k>1: MULTI-CHUNK TICKS, where a slot with k
        full windows buffered runs them in ONE step with a block-causal
        sub-chunk mask (equal to k single ticks); it adds up to
        (k-1)·640 ms of buffering before the first partial result, and
        falls back to 1 unless k·16 ≤ the cache size and the encoder
        takes multi-chunk steps (`multi_chunk`). pos_table_len: rows
        of the per-layer position tables (~pos_table_len × 40 ms of stream
        per slot before its ticks switch to exact per-tick positions,
        which are as right, only slower)."""
        if decoder not in ("ctc_greedy", "ctc_beam_search_device"):
            raise ValueError(f"unknown engine decoder {decoder!r}")
        self.ip = inference_predictor
        self.decoder = decoder
        self.N = max_streams
        self.vocab_list = vocab_list
        self._featurizer = AudioFeaturizer(train=False,
                                           **(preprocess_conf or {}))
        encoder = self.ip.model.encoder
        C = self.ip.cache_size
        self.tick_k = int(tick_chunks) \
            if encoder.multi_chunk and 1 < tick_chunks \
            and tick_chunks * DECODING_CHUNK_SIZE <= C else 1
        self.states = encoder.init_cache(
            batch=max_streams, cache_size=C, device=self.ip.device)
        # kernel weights and per-layer position tables, made once
        # (None for an encoder without a chunk kernel)
        self._packed_chunk = encoder.pack_chunk_params(
            cache_size=C, pos_table_len=int(pos_table_len))
        # position-table horizon: a slot whose offset reaches the last
        # full window of the table takes the exact-positions step from
        # then on (offsets are mirrored on the host: routing needs no
        # readback); None: the encoder has no tables
        L = C + DECODING_CHUNK_SIZE * self.tick_k
        self._pos_cap = max(0, int(pos_table_len) - L) \
            if encoder.position_tables else None
        self._slot_frames = [0] * max_streams

        self._dec_state = None
        if decoder == "ctc_beam_search_device":
            conf = dict(decoder_conf or {})
            init_fn, self._decode_fn = make_stream_decode_fn(
                **device_beam_conf(conf, vocab_list, self.ip.device),
                max_len=int(conf.get("max_len", 512)),
                space_id=space_id_of(vocab_list), device=self.ip.device)
            self._dec_fresh = init_fn(1)
            self._dec_state = init_fn(max_streams)

        # per-slot host state
        self._cached_feat = [None] * max_streams
        self._remainder = [np.zeros(0, np.float32)] * max_streams
        self._decoders = [GreedyChunkDecoder(vocab_list)
                          for _ in range(max_streams)]
        self._in_use = [False] * max_streams

    # ------------------------------------------------------------------ #
    def open(self):
        """→ slot id for a new stream (raises if all slots busy)."""
        for i, used in enumerate(self._in_use):
            if not used:
                self._in_use[i] = True
                return i
        raise RuntimeError(f"all {self.N} stream slots are in use")

    def close(self, slot):
        self._in_use[slot] = False
        self._cached_feat[slot] = None
        self._remainder[slot] = np.zeros(0, np.float32)
        self._slot_frames[slot] = 0
        self._decoders[slot].reset()
        if self._dec_state is not None:
            for k, v in self._dec_state.items():
                v[slot] = self._dec_fresh[k][0]
        # the slot's rows of every state tensor go back to init_cache's
        # zeros: (L, N, ...) caches and carries, (N,) counters
        for v in self.states.values():
            (v[slot] if v.dim() == 1 else v[:, slot]).zero_()

    # ------------------------------------------------------------------ #
    def _run_round(self, xs, active, valids):
        """One tick: encoder + greedy head for the active slots.
        xs: (N, k, DECODING_WINDOW, feat), k = 1 or tick_k. valids: {slot:
        valid OUTPUT frames this tick} → {slot: (score, text)}. Slots past
        the position-table horizon take the exact-positions step, the rest
        stay on the tables: a mixed tick dispatches the two over disjoint
        active masks. Without tables every active slot goes in one
        dispatch."""
        adv = xs.shape[1] * DECODING_CHUNK_SIZE
        crossed = np.asarray([bool(active[s]) and self._pos_cap is not None
                              and self._slot_frames[s] >= self._pos_cap
                              for s in range(self.N)])
        table = np.asarray(active, bool) & ~crossed
        for s in range(self.N):
            if active[s]:
                self._slot_frames[s] += adv
        out = {}
        for mask, exact in ((table, False), (crossed, True)):
            if mask.any():
                sub_valids = {s: n for s, n in valids.items() if mask[s]}
                out.update(self._dispatch(xs, mask, sub_valids, exact))
        return out

    def _dispatch(self, xs, active, valids, exact):
        """One batched chunk step over the `active` slots, all on one
        positions route, then the decoder; inactive slots' state is left
        untouched."""
        dev = self.ip.device
        inp = torch.from_numpy(xs[:, 0] if xs.shape[1] == 1 else xs).to(dev)
        with torch.no_grad():
            probs = self.ip.model.get_encoder_out_chunk_batched(
                inp, self.states, self._packed_chunk,
                torch.from_numpy(np.asarray(active, bool)).to(dev), exact)
        if self._dec_state is not None:
            return self._beam_step(probs, valids)
        ids, maxp = greedy_head(probs)
        out = {}
        for slot, n in valids.items():
            n = min(n, ids.shape[1])
            if n:
                out[slot] = self._decoders[slot].decode_chunk_ids(
                    ids[slot, :n], maxp[slot, :n])
        return out

    def _beam_step(self, probs, valids):
        """Every slot's beam over the dispatch's probs (N, T, V), only the
        `valids` frames of each slot valid → {slot: (score, text)}."""
        fv = np.zeros(probs.shape[:2], bool)
        for slot, n in valids.items():
            fv[slot, :n] = True
        self._dec_state, best = self._decode_fn(
            self._dec_state, probs, torch.from_numpy(fv).to(probs.device))
        tokens, lengths, scores = (x.cpu().numpy() for x in best)
        return {slot: (float(scores[slot]), ids_to_text(
            tokens[slot][: int(lengths[slot])], self.vocab_list))
            for slot, n in valids.items() if n}

    # ------------------------------------------------------------------ #
    def _append_features(self, slot, samples, sample_rate):
        samples = np.concatenate([self._remainder[slot],
                                  np.asarray(samples, np.float32)])
        feats = self._featurizer.featurize_waveform(samples, sample_rate)
        hop = int(self._featurizer.sample_rate * 0.01)
        self._remainder[slot] = samples[hop * feats.shape[0]:]
        cf = self._cached_feat[slot]
        self._cached_feat[slot] = feats if cf is None else \
            np.concatenate([cf, feats], axis=0)
        return self._cached_feat[slot].shape[0]

    def feed(self, slot, samples, is_end=False, sample_rate=16000):
        """Add PCM float samples to a slot; → {'text','score'} | None."""
        if not self._in_use[slot]:
            raise ValueError(f"slot {slot} is not open")
        num_frames = self._append_features(slot, samples, sample_rate)
        if num_frames < DECODING_WINDOW and not is_end:
            return None
        if num_frames < CONTEXT:
            return None
        left = CONTEXT if is_end else DECODING_WINDOW
        result = None
        end = None
        windows = []
        for cur in range(0, num_frames - left + 1, STRIDE):
            end = min(cur + DECODING_WINDOW, num_frames)
            windows.append(self._cached_feat[slot][cur:end])
        idx = 0
        k = self.tick_k
        # full windows group into multi-chunk ticks; the (possibly short)
        # tail and partial groups take the single-chunk step
        while k > 1 and len(windows) - idx >= k \
                and windows[idx + k - 1].shape[0] == DECODING_WINDOW:
            result = self._advance(slot, windows[idx:idx + k])
            idx += k
        for window in windows[idx:]:
            result = self._advance(slot, [window])
        if end is not None:
            self._cached_feat[slot] = \
                self._cached_feat[slot][end - CACHED_FEATURE_NUM:]
        return result

    def _advance(self, slot, windows):
        """One tick of a single slot over len(windows) windows (1, or
        tick_k full ones)."""
        k = len(windows)
        valid_len = windows[-1].shape[0]
        xs = np.zeros((self.N, k, DECODING_WINDOW, windows[0].shape[1]),
                      np.float32)
        for j, w in enumerate(windows):
            xs[slot, j, :w.shape[0]] = w
        active = np.zeros((self.N,), bool)
        active[slot] = True
        valid = (k - 1) * DECODING_CHUNK_SIZE \
            + max(_subsampled_len(valid_len), 0)
        decoded = self._run_round(xs, active, {slot: valid})
        if slot not in decoded:
            return None
        score, text = decoded[slot]
        return {"text": text, "score": score}

    def feed_many(self, items, sample_rate=16000):
        """Advance several streams in one device step when their windows
        align: items = [(slot, samples, is_end)] → {slot: result|None}.
        Slots whose buffers fill a window are batched into one tick."""
        ready = {}
        results = {}
        for slot, samples, is_end in items:
            if not self._in_use[slot]:
                raise ValueError(f"slot {slot} is not open")
            n = self._append_features(slot, samples, sample_rate)
            left = CONTEXT if is_end else DECODING_WINDOW
            if n >= max(left, CONTEXT):
                ready[slot] = is_end
            results[slot] = None
        feat_dim = self._featurizer.feature_dim
        if self.tick_k > 1:
            # multi-chunk rounds first: every slot with tick_k full
            # windows buffered advances k chunks in ONE step
            k = self.tick_k
            need = DECODING_WINDOW + (k - 1) * STRIDE
            while True:
                group = [s for s in ready
                         if self._cached_feat[s].shape[0] >= need]
                if not group:
                    break
                xs = np.zeros((self.N, k, DECODING_WINDOW, feat_dim),
                              np.float32)
                active = np.zeros((self.N,), bool)
                valids = {}
                for slot in group:
                    for j in range(k):
                        xs[slot, j] = self._cached_feat[slot][
                            j * STRIDE:j * STRIDE + DECODING_WINDOW]
                    active[slot] = True
                    valids[slot] = k * DECODING_CHUNK_SIZE
                    self._cached_feat[slot] = \
                        self._cached_feat[slot][k * STRIDE:]
                for slot, (score, text) in self._run_round(
                        xs, active, valids).items():
                    results[slot] = {"text": text, "score": score}
        while ready:
            xs = np.zeros((self.N, 1, DECODING_WINDOW, feat_dim), np.float32)
            active = np.zeros((self.N,), bool)
            valids = {}
            for slot, is_end in list(ready.items()):
                n = self._cached_feat[slot].shape[0]
                left = CONTEXT if is_end else DECODING_WINDOW
                if n < left:
                    ready.pop(slot)
                    continue
                end = min(DECODING_WINDOW, n)
                xs[slot, 0, :end] = self._cached_feat[slot][:end]
                active[slot] = True
                valids[slot] = max(_subsampled_len(end), 0)
                # consume one stride; keep the feature-context tail
                self._cached_feat[slot] = self._cached_feat[slot][
                    min(STRIDE, end - CACHED_FEATURE_NUM):]
            if not active.any():
                break
            for slot, (score, text) in self._run_round(xs, active,
                                                       valids).items():
                results[slot] = {"text": text, "score": score}
        return results
