"""Voice activity detection (port of masr_tpu/infer/vad.py, itself the
reference's masr/infer_utils/vad_predictor.py API: get_speech_timestamps +
stream_vad).

Per-window speech probabilities come from the REAL silero-VAD model: the
same `silero_vad.onnx` the reference bundles (vad_predictor.py:36-104) is
executed by the in-repo numpy ONNX interpreter
(the port's copy, masr_tpu_torch/infer/onnx_runtime.py) — no onnxruntime
needed. The model file is the port's own copy beside this module. VAD is
host work: numpy on the CPU, whatever device the recognizer runs on. The
hysteresis / minimum-duration / padding / merging semantics match the
reference (vad_predictor.py:106-213): 512-sample windows @16 kHz, speech
prob with threshold 0.5, neg_threshold = threshold - 0.15, min speech
250 ms, min silence 100 ms, 30 ms pad.

If the model file is missing, an adaptive energy + spectral-flatness
heuristic (the original fallback) keeps the same API working.
"""
import os

import numpy as np

from masr_tpu_torch.utils.logger import setup_logger

logger = setup_logger()

_SILERO_PATH = os.path.join(os.path.dirname(__file__), "silero_vad.onnx")


class SileroVAD(object):
    """The silero-VAD v3 model, run by the in-repo ONNX executor.

    Stateful like the reference's onnxruntime session
    (vad_predictor.py:73-104): h/c LSTM state (2, B, 64) carried between
    512-sample windows; `reset_states()` between utterances/streams."""

    def __init__(self, model_path=None):
        from masr_tpu_torch.infer.onnx_runtime import OnnxModel
        self.model = OnnxModel(model_path or _SILERO_PATH)
        expected = {"input", "sr", "h", "c"}
        if set(self.model.input_names) != expected:
            raise ValueError(
                f"not a silero VAD graph: inputs {self.model.input_names}")
        self._fast = self._build_fast()
        self.reset_states()

    def _build_fast(self):
        """Prepare the vectorized offline path (see run_sequence).

        Locates the 16 kHz branch, the cut point where the graph starts
        reading the LSTM state, the two LSTM layers' weights, and the
        1x1-conv decoder head. Returns None on any structural mismatch —
        callers then keep the per-window interpreter loop, so a different
        silero export degrades to the slow path instead of breaking."""
        try:
            g = self.model.graph
            eq, iff = g.nodes
            if eq.op != "Equal" or iff.op != "If":
                return None
            is16k = int(np.asarray(g.inits[eq.inputs[1]]).reshape(())) == 16000
            branch = iff.attrs["then_branch" if is16k else "else_branch"].g
            # frontend = everything before the first read of the h state
            cut = next(i for i, n in enumerate(branch.nodes)
                       if "h" in n.inputs)
            lstm_if = next(n for n in branch.nodes[cut:] if n.op == "If")
            sg = lstm_if.attrs["then_branch"].g
            lstms = [n for n in sg.nodes if n.op == "LSTM"]
            if len(lstms) != 2:
                return None
            seq_name = lstms[0].inputs[0]
            weights = []
            for n in lstms:
                W, R, B = (sg.inits[n.inputs[i]] for i in (1, 2, 3))
                weights.append((W, R, B, n.attrs["hidden_size"].i))
            inits = dict(g.inits)
            inits.update(branch.inits)
            wd = inits["model.decoder.decoder.1.weight"]  # (1, H, 1)
            bd = inits["model.decoder.decoder.1.bias"]    # (1,)
            if wd.ndim != 3 or wd.shape[0] != 1 or wd.shape[2] != 1:
                return None
            return dict(branch=branch, cut=cut, inits=inits, seq=seq_name,
                        lstms=weights, wd=wd[0, :, 0], bd=float(bd[0]))
        except Exception:
            return None

    def run_sequence(self, windows, sr=16000, block=4096):
        """Chained-window speech probs, vectorized: equivalent to calling
        self(w) per row with carried h/c state, but ~20x faster.

        In this graph each 512-sample window reduces to exactly ONE LSTM
        timestep (the conv encoder's output is (B, 64, 1)), so the conv
        frontend runs batched over all windows (bit-exact vs per-window —
        every reduction stays within a window), the two LSTM layers run
        once over the window sequence, and the 1x1-conv sigmoid head runs
        batched. windows: (N, window) float32 → (N,) probs; h/c updated
        to the state after the last window."""
        fast = self._fast
        if fast is None or int(sr) != 16000:
            raise NotImplementedError("vectorized silero path unavailable")
        from masr_tpu_torch.infer.onnx_runtime import _lstm, _sigmoid
        windows = np.ascontiguousarray(windows, np.float32)
        if self._h.shape[1] != 1:
            self.reset_states(1)
        n = windows.shape[0]
        out = np.empty(n, np.float32)
        for s in range(0, n, block):  # bound frontend memory on long audio
            wb = windows[s:s + block]
            env = dict(fast["inits"])
            env["input"] = wb
            env["sr"] = np.asarray(sr, np.int64)
            for node in fast["branch"].nodes[:fast["cut"]]:
                self.model._run_node(node, env)
            x = env[fast["seq"]]      # (1, nb, 64): per-window frames
            x = x[0][:, None, :]      # (nb, 1, 64): the chained sequence
            hs, cs = [], []
            for li, (W, R, B, H) in enumerate(fast["lstms"]):
                x, h, c = _lstm(x, W, R, B, self._h[li:li + 1],
                                self._c[li:li + 1], H)
                x = x[:, 0]           # (nb, 1, H)
                hs.append(h)
                cs.append(c)
            self._h = np.concatenate(hs, 0)
            self._c = np.concatenate(cs, 0)
            out[s:s + block] = _sigmoid(
                np.maximum(x[:, 0], 0.0) @ fast["wd"] + fast["bd"])
        return out

    def reset_states(self, batch_size=1):
        self._h = np.zeros((2, batch_size, 64), np.float32)
        self._c = np.zeros((2, batch_size, 64), np.float32)

    def __call__(self, x, sr=16000):
        """x: (window,) or (B, window) float32 → speech prob scalar
        (B=1) or (B,) array; LSTM state carried across calls."""
        x = np.asarray(x, np.float32)
        squeeze = x.ndim == 1
        if squeeze:
            x = x[None]
        if x.shape[0] != self._h.shape[1]:
            self.reset_states(x.shape[0])
        out = self.model.run({"input": x, "sr": np.asarray(sr, np.int64),
                              "h": self._h, "c": self._c})
        self._h, self._c = out["hn"], out["cn"]
        p = np.asarray(out["output"], np.float32).reshape(-1)
        return float(p[0]) if squeeze else p


class VADPredictor(object):
    def __init__(self, threshold=0.5, sampling_rate=16000,
                 window_size_samples=512, use_model=True, model_path=None):
        self.threshold = threshold
        self.sampling_rate = sampling_rate
        self.window_size_samples = window_size_samples
        self.silero = None
        if use_model:
            try:
                self.silero = SileroVAD(model_path)
            except Exception as e:
                logger.warning(f"silero VAD model unavailable ({e}); "
                               f"using the energy/flatness heuristic")
        self.reset_states()

    # ------------------------------------------------------------------ #
    # frame-level speech probability
    # ------------------------------------------------------------------ #
    def _frame_features(self, wav):
        """→ (rms_db (N,), flatness (N,)) per 512-sample window."""
        n = len(wav) // self.window_size_samples
        if n == 0:
            return np.zeros(0), np.zeros(0)
        frames = wav[: n * self.window_size_samples].reshape(
            n, self.window_size_samples)
        rms = np.sqrt(np.mean(frames ** 2, axis=1) + 1e-12)
        rms_db = 20 * np.log10(rms + 1e-12)
        spec = np.abs(np.fft.rfft(frames, axis=1)) + 1e-12
        # spectral flatness: geometric/arithmetic mean; noise ≈ 1, voice « 1
        flat = np.exp(np.mean(np.log(spec), axis=1)) / np.mean(spec, axis=1)
        return rms_db, flat

    def _speech_probs(self, wav):
        if self.silero is not None:
            return self._silero_probs(wav)
        rms_db, flat = self._frame_features(wav)
        if len(rms_db) == 0:
            return np.zeros(0)
        # adaptive noise floor: 15th percentile of frame energy
        floor = np.percentile(rms_db, 15)
        snr = rms_db - floor  # dB above noise floor
        p_energy = 1.0 / (1.0 + np.exp(-(snr - 9.0) / 3.0))
        p_tonal = 1.0 / (1.0 + np.exp((flat - 0.5) / 0.1))
        return 0.7 * p_energy + 0.3 * p_tonal

    def _silero_probs(self, wav):
        """Model-based per-window probs (vad_predictor.py:117-121 loop:
        fresh LSTM state per utterance, zero-pad the last partial window).
        Offline audio rides the vectorized run_sequence path when the
        graph supports it (identical probs, ~20x faster on long audio)."""
        win = self.window_size_samples
        self.silero.reset_states()
        n = -(-len(wav) // win) if len(wav) else 0
        if n == 0:
            return np.zeros(0, np.float32)
        if (self.silero._fast is not None and win == 512
                and int(self.sampling_rate) == 16000):
            wav = np.asarray(wav, np.float32)
            if len(wav) < n * win:
                wav = np.pad(wav, (0, n * win - len(wav)))
            return self.silero.run_sequence(wav.reshape(n, win),
                                            self.sampling_rate)
        probs = np.zeros(n, np.float32)
        for i in range(n):
            frame = wav[i * win: (i + 1) * win]
            if len(frame) < win:
                frame = np.pad(frame, (0, win - len(frame)))
            probs[i] = self.silero(frame, self.sampling_rate)
        return probs

    # ------------------------------------------------------------------ #
    # offline segmentation (vad_predictor.py:106-175 semantics)
    # ------------------------------------------------------------------ #
    def get_speech_timestamps(self, wav, sampling_rate=None,
                              min_speech_duration_ms=250,
                              max_speech_duration_s=float("inf"),
                              min_silence_duration_ms=100,
                              speech_pad_ms=30):
        sr = sampling_rate or self.sampling_rate
        wav = np.asarray(wav, dtype=np.float32)
        win = self.window_size_samples
        probs = self._speech_probs(wav)
        threshold = self.threshold
        neg_threshold = threshold - 0.15
        min_speech = sr * min_speech_duration_ms / 1000
        min_silence = sr * min_silence_duration_ms / 1000
        pad = int(sr * speech_pad_ms / 1000)
        max_speech = (sr * max_speech_duration_s - win - 2 * pad
                      if max_speech_duration_s < float("inf") else float("inf"))

        triggered = False
        speeches = []
        current = {}
        temp_end = 0
        for i, p in enumerate(probs):
            pos = win * i
            if p >= threshold and temp_end:
                temp_end = 0
            if p >= threshold and not triggered:
                triggered = True
                current["start"] = pos
                continue
            if triggered and pos - current["start"] > max_speech:
                current["end"] = pos
                speeches.append(current)
                current = {}
                triggered = False
                temp_end = 0
                continue
            if p < neg_threshold and triggered:
                if not temp_end:
                    temp_end = pos
                if pos - temp_end < min_silence:
                    continue
                current["end"] = temp_end
                if current["end"] - current["start"] > min_speech:
                    speeches.append(current)
                current = {}
                triggered = False
                temp_end = 0
        if triggered and len(wav) - current["start"] > min_speech:
            current["end"] = len(wav)
            speeches.append(current)

        # pad and merge (vad_predictor.py:158-172)
        for i, sp in enumerate(speeches):
            if i == 0:
                sp["start"] = int(max(0, sp["start"] - pad))
            if i != len(speeches) - 1:
                gap = speeches[i + 1]["start"] - sp["end"]
                if gap < 2 * pad:
                    sp["end"] += gap // 2
                    speeches[i + 1]["start"] = int(
                        max(0, speeches[i + 1]["start"] - gap // 2))
                else:
                    sp["end"] = int(min(len(wav), sp["end"] + pad))
                    speeches[i + 1]["start"] = int(
                        max(0, speeches[i + 1]["start"] - pad))
            else:
                sp["end"] = int(min(len(wav), sp["end"] + pad))
        return speeches

    # ------------------------------------------------------------------ #
    # streaming start/end events (vad_predictor.py:177-213 semantics)
    # ------------------------------------------------------------------ #
    def reset_states(self):
        self._stream_buf = np.zeros(0, dtype=np.float32)
        self._stream_pos = 0
        self._triggered = False
        self._temp_end = 0
        self._noise_floor = None
        if self.silero is not None:
            self.silero.reset_states()

    def stream_vad(self, chunk, sampling_rate=None,
                   min_silence_duration_ms=100, speech_pad_ms=30):
        """Feed samples incrementally; yields {'start': n} / {'end': n} events."""
        sr = sampling_rate or self.sampling_rate
        win = self.window_size_samples
        pad = int(sr * speech_pad_ms / 1000)
        min_silence = sr * min_silence_duration_ms / 1000
        self._stream_buf = np.concatenate(
            [self._stream_buf, np.asarray(chunk, np.float32)])
        events = []
        while len(self._stream_buf) >= win:
            frame = self._stream_buf[:win]
            self._stream_buf = self._stream_buf[win:]
            pos = self._stream_pos
            self._stream_pos += win
            if self.silero is not None:
                p = self.silero(frame, sr)
            else:
                rms_db = 20 * np.log10(
                    np.sqrt(np.mean(frame ** 2) + 1e-12) + 1e-12)
                if self._noise_floor is None:
                    self._noise_floor = rms_db
                # slow noise-floor tracker (rises slowly, falls fast)
                if rms_db < self._noise_floor:
                    self._noise_floor += 0.3 * (rms_db - self._noise_floor)
                else:
                    self._noise_floor += 0.02 * (rms_db - self._noise_floor)
                p = 1.0 / (1.0 + np.exp(
                    -((rms_db - self._noise_floor) - 9.0) / 3.0))
            if p >= self.threshold and self._temp_end:
                self._temp_end = 0
            if p >= self.threshold and not self._triggered:
                self._triggered = True
                events.append({"start": int(max(0, pos - pad))})
            elif p < self.threshold - 0.15 and self._triggered:
                if not self._temp_end:
                    self._temp_end = pos
                if pos - self._temp_end >= min_silence:
                    events.append({"end": int(self._temp_end + pad)})
                    self._triggered = False
                    self._temp_end = 0
        return events
