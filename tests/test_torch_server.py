"""The port's server (masr_tpu_torch/infer/server.py) on the CPU, as
tests/test_server.py drives masr_tpu's: REST short and long audio (raw and
multipart bodies, use_pun / is_itn, 400 / 404, /stats), the WebSocket
stream on one predictor with its busy guard, the batched engine behind
max_streams (concurrent streams kept apart, slot overflow, the device beam
as the engine's decoder), ServerStats; each REST reply's text and score
against masr_tpu's predictor on the same audio, the stream's replies
against masr_tpu's predict_stream, the batched streams' replies against
masr_tpu's batched server fed the same messages; and the handler threads'
kernel routes (a new thread starts with grad mode on)."""
import asyncio
import json
import os
import socket
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
from test_torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
BUNDLE = os.path.join(REPO, "examples", "tiny_zh_synth", "inference_model")
SENTENCES = [("上家音月火少", 0), ("风大你火下雪", 1), ("蓝右黑真", 0)]


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _render(text, spk):
    """The synthetic voice over a -60 dB noise floor (the engine, as
    masr_tpu's, refuses a window of digital silence)."""
    from masr_tpu_torch.audio.synth_tts import SyntheticTTS
    wav = SyntheticTTS(sample_rate=16000).render(text, spk_id=spk)
    noise = np.random.RandomState(len(text) + spk).standard_normal(len(wav))
    return (wav + 1e-3 * noise).astype(np.float32)


def _wav_bytes(wav, path):
    from masr_tpu_torch.audio.io import write_wave
    write_wave(path, wav, 16000)
    with open(path, "rb") as f:
        return f.read()


@pytest.fixture(scope="module")
def audio(tmp_path_factory):
    """WAV bytes: one held-out sentence, and the three with silences."""
    d = tmp_path_factory.mktemp("srv_audio")
    wavs = [_render(t, s) for t, s in SENTENCES]
    sil = np.zeros(12000, np.float32)
    long = np.concatenate([sil] + [x for w in wavs for x in (w, sil)])
    return {"short": _wav_bytes(wavs[0], str(d / "short.wav")),
            "long": _wav_bytes(long, str(d / "long.wav")),
            "stream": np.concatenate(wavs[:2])}


def _start(pred, **kw):
    from masr_tpu_torch.infer.server import ASRServer
    srv = ASRServer(pred, host="127.0.0.1", port=_free_port(),
                    ws_port=_free_port(), **kw)
    srv.start(block=False)
    time.sleep(0.5)
    return srv


@pytest.fixture(scope="module")
def server():
    from masr_tpu.infer.predictor import MASRPredictor as JaxPredictor
    from masr_tpu_torch.infer.predictor import MASRPredictor
    pred = MASRPredictor(BUNDLE, device="cpu", use_pun=True, warmup=False)
    srv = _start(pred)
    yield {"srv": srv, "pred": pred,
           "ref": JaxPredictor(BUNDLE, use_pun=True, warmup=False)}
    srv.stop()


def _post(srv, path, body, ctype="application/octet-stream"):
    req = urllib.request.Request(f"http://127.0.0.1:{srv.port}{path}",
                                 data=body, headers={"Content-Type": ctype})
    try:
        with urllib.request.urlopen(req) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(srv, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{srv.port}{path}") as r:
        return r.status, r.read()


def _multipart(raw):
    boundary = "bnd123"
    body = (f"--{boundary}\r\nContent-Disposition: form-data; "
            f'name="audio"; filename="t.wav"\r\nContent-Type: audio/wav'
            f"\r\n\r\n").encode() + raw + f"\r\n--{boundary}--\r\n".encode()
    return body, f"multipart/form-data; boundary={boundary}"


def test_index_page(server):
    status, body = _get(server["srv"], "/")
    assert status == 200 and b"masr_tpu" in body


@pytest.mark.parametrize("body", ["raw", "multipart"])
def test_recognition_equals_masr_tpu(server, audio, body):
    """/recognition: masr_tpu's text, its score within 1e-3."""
    raw = audio["short"]
    data, ctype = (raw, "application/octet-stream") if body == "raw" \
        else _multipart(raw)
    status, r = _post(server["srv"], "/recognition", data, ctype)
    want = server["ref"].predict(raw)
    assert status == 200 and r["code"] == 0 and r["msg"] == "success"
    assert r["result"] == want["text"] == SENTENCES[0][0]
    assert abs(r["score"] - want["score"]) <= 1e-3


def test_recognition_long_audio_equals_masr_tpu(server, audio):
    """/recognition_long_audio: masr_tpu's predict_long text (three VAD
    segments joined by '，'), the score within one rounding step."""
    status, r = _post(server["srv"], "/recognition_long_audio",
                      audio["long"])
    want = server["ref"].predict_long(audio["long"])
    assert status == 200 and r["result"] == want["text"]
    assert r["result"].count("，") == 2
    assert abs(r["score"] - want["score"]) <= 0.01


@pytest.mark.parametrize("path", ["/recognition", "/recognition_long_audio"])
def test_use_pun_and_is_itn_equal_masr_tpu(server, audio, path):
    srv = server["srv"]
    raw = audio["short"] if path == "/recognition" else audio["long"]
    srv.use_pun = srv.is_itn = True
    try:
        status, r = _post(srv, path, raw)
    finally:
        srv.use_pun = srv.is_itn = False
    ref = server["ref"]
    want = (ref.predict if path == "/recognition" else ref.predict_long)(
        raw, use_pun=True, is_itn=True)
    assert status == 200 and r["result"] == want["text"]
    assert r["result"].endswith("。")


def test_no_audio_400_and_unknown_paths_404(server, audio):
    srv = server["srv"]
    assert _post(srv, "/recognition", b"")[0] == 400
    assert _post(srv, "/no_such_path", audio["short"])[0] == 404
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(srv, "/no_such_path")
    assert e.value.code == 404


def test_stats_endpoint(server, audio):
    """/stats counts a successful request without an error, with its
    latency percentiles."""
    srv = server["srv"]
    before = json.loads(_get(srv, "/stats")[1])["endpoints"].get(
        "/recognition", {"count": 0, "errors": 0})
    _post(srv, "/recognition", audio["short"])
    stats = json.loads(_get(srv, "/stats")[1])
    rec = stats["endpoints"]["/recognition"]
    assert rec["count"] == before["count"] + 1
    assert rec["errors"] == before["errors"]
    assert rec["p50_ms"] is not None and rec["p50_ms"] > 0
    assert set(stats["streaming"]) == {"active", "sessions_total",
                                       "chunks_total"}


def test_stats_unit():
    from masr_tpu_torch.infer.server import ServerStats
    s = ServerStats()
    for ms in (10, 20, 30, 40, 100):
        s.observe("/x", ms / 1000.0)
    s.observe("/x", 0.5, ok=False)
    s.stream_opened()
    s.stream_chunk()
    s.stream_chunk()
    s.stream_closed()
    snap = s.snapshot()
    assert snap["endpoints"]["/x"]["count"] == 6
    assert snap["endpoints"]["/x"]["errors"] == 1
    assert 20 <= snap["endpoints"]["/x"]["p50_ms"] <= 100
    assert snap["streaming"] == {"active": 0, "sessions_total": 1,
                                 "chunks_total": 2}


# --------------------------------------------------------------------------- #
# WebSocket streams
# --------------------------------------------------------------------------- #
def _pieces(wav, piece=10240):
    """int16 PCM messages of 0.64 s, the last one ending b"end"."""
    pcm = (np.clip(wav, -1, 1) * 32767).astype(np.int16).tobytes()
    step = 2 * piece
    return [pcm[i:i + step] + (b"end" if i + step >= len(pcm) else b"")
            for i in range(0, len(pcm), step)]


def _replies(feed, pieces):
    """[(a reply is due, its text)] of feed(payload, is_end) per message."""
    out = []
    for msg in pieces:
        end = msg.endswith(b"end")
        r = feed(msg[:-3] if end else msg, end)
        out.append((end or r is not None, (r or {"text": ""})["text"]))
    return out


async def _stream(uri, pieces, due):
    import websockets
    texts = []
    async with websockets.connect(uri) as ws:
        for msg, (reply, _) in zip(pieces, due):
            await ws.send(msg)
            if reply:
                r = json.loads(await ws.recv())
                assert r["code"] == 0
                texts.append(r["result"])
        assert r["is_end"] is True
    return texts


def test_websocket_stream_equals_masr_tpu_predict_stream(server, audio):
    """Every reply of a stream in 0.64 s messages == masr_tpu's
    predict_stream over the same PCM messages."""
    ref = server["ref"]
    pieces = _pieces(audio["stream"])
    due = _replies(lambda p, e: ref.predict_stream(p, is_end=e), pieces)
    ref.reset_stream()
    texts = asyncio.run(_stream(f"ws://127.0.0.1:{server['srv'].ws_port}/",
                                pieces, due))
    assert texts == [t for reply, t in due if reply]
    assert texts[-1].startswith(SENTENCES[0][0])


def test_single_predictor_busy_guard(server, audio):
    """A second concurrent stream is refused; the first finishes."""
    import websockets
    uri = f"ws://127.0.0.1:{server['srv'].ws_port}/"
    pcm = b"".join(_pieces(audio["stream"]))[:-3]

    async def run():
        async with websockets.connect(uri) as ws1:
            await ws1.send(pcm[:16000])
            await asyncio.sleep(0.3)
            async with websockets.connect(uri) as ws2:
                msg = json.loads(await ws2.recv())
                assert msg["code"] == 1 and "busy" in msg["msg"]
            await ws1.send(pcm[16000:] + b"end")
            while True:
                m = json.loads(await ws1.recv())
                if m.get("is_end"):
                    return m

    final = asyncio.run(run())
    assert final["code"] == 0 and final["result"]


async def _session(uri, utterances):
    """One connection, its utterances in turn: each one's messages sent at
    once and its replies read up to the final one. Every utterance but the
    last ends on b"end" (the engine's slot is closed and opened again); the
    last ends on the text message "end" → [(is_end, text, score)]."""
    import websockets
    out = []
    async with websockets.connect(uri) as ws:
        for k, pieces in enumerate(utterances):
            msgs = list(pieces)
            if k == len(utterances) - 1:
                msgs[-1:] = [msgs[-1][:-3], "end"]
            for m in msgs:
                await ws.send(m)
            while True:
                r = json.loads(await ws.recv())
                assert r["code"] == 0
                out.append((r["is_end"], r["result"], r.get("score")))
                if r["is_end"]:
                    break
    return out


def _same_replies(got, want):
    """The same replies in the same order: equal texts, final scores within
    1e-3."""
    assert [(e, t) for e, t, _ in got] == [(e, t) for e, t, _ in want]
    for (e, _, a), (_, _, b) in zip(got, want):
        assert not e or abs(a - b) <= 1e-3


def _start_both(max_streams, **pred_kw):
    """The example bundle served with max_streams by the port (CPU) and by
    masr_tpu → (port's server, masr_tpu's server)."""
    from masr_tpu.infer.predictor import MASRPredictor as JaxPredictor
    from masr_tpu.infer.server import ASRServer as JaxServer
    from masr_tpu_torch.infer.predictor import MASRPredictor
    pred = MASRPredictor(BUNDLE, device="cpu", warmup=False, **pred_kw)
    ref = JaxServer(JaxPredictor(BUNDLE, warmup=False, **pred_kw),
                    host="127.0.0.1", port=_free_port(), ws_port=_free_port(),
                    max_streams=max_streams)
    ref.start(block=False)
    return _start(pred, max_streams=max_streams), ref


@pytest.fixture(scope="module")
def batched_servers():
    srv, ref = _start_both(4)
    yield {"srv": srv, "ref": ref}
    srv.stop()
    ref.stop()


def test_batched_ws_concurrent_streams_kept_apart(batched_servers):
    """Three connections at once through the port's engine, two utterances
    each (the second after the slot was reopened, ended by the text "end")
    == every reply of masr_tpu's batched server to each connection alone."""
    uri = "ws://127.0.0.1:{}/"
    wavs = [_render(t, s) for t, s in SENTENCES]
    conns = [[_pieces(wavs[k]), _pieces(wavs[(k + 1) % 3])]
             for k in range(3)]
    want = [asyncio.run(_session(uri.format(batched_servers["ref"].ws_port),
                                 c)) for c in conns]

    async def together():
        port_uri = uri.format(batched_servers["srv"].ws_port)
        return await asyncio.gather(*[_session(port_uri, c) for c in conns])

    got = asyncio.run(together())
    for g, w in zip(got, want):
        _same_replies(g, w)
    finals = [t for g in got for e, t, _ in g if e]
    assert finals[::2] == [t for t, _ in SENTENCES]


def test_batched_ws_slot_overflow_rejected(batched_servers):
    """A fifth connection to a 4-slot server gets masr_tpu's refusal."""
    import websockets

    async def run(port):
        uri = f"ws://127.0.0.1:{port}/"
        conns = [await websockets.connect(uri) for _ in range(4)]
        await asyncio.sleep(0.3)
        try:
            async with websockets.connect(uri) as ws5:
                return json.loads(await ws5.recv())
        finally:
            for c in conns:
                await c.close()

    got = asyncio.run(run(batched_servers["srv"].ws_port))
    assert got["code"] == 1 and "slots" in got["msg"]
    assert got == asyncio.run(run(batched_servers["ref"].ws_port))


def test_batched_ws_with_beam_decoder():
    """A beam-configured predictor's engine decodes with the device beam
    and the predictor's beam config: every reply of two utterances on one
    connection == masr_tpu's batched server's."""
    conf = {"beam_size": 4, "cutoff_top_n": 4}
    srv, ref = _start_both(2, decoder="ctc_beam_search",
                           decoder_configs=conf)
    try:
        assert srv.batch_session.decoder == "ctc_beam_search_device"
        assert srv.batch_session.decoder == ref.batch_session.decoder
        utts = [_pieces(_render(*SENTENCES[1])),
                _pieces(_render(*SENTENCES[2]))]
        got, want = (asyncio.run(_session(f"ws://127.0.0.1:{s.ws_port}/",
                                          utts)) for s in (srv, ref))
        _same_replies(got, want)
        assert [t for e, t, _ in got if e] == [SENTENCES[1][0],
                                               SENTENCES[2][0]]
    finally:
        srv.stop()
        ref.stop()


def test_handler_threads_take_the_flash_route(tmp_path, monkeypatch):
    """A static-chunk bundle (the port's exporter, seeded weights) served
    over REST: the handler thread's encode runs every layer's attention
    on the flash route (the kernel's, under the predictor's no_grad), not
    the eager attention, and its text is masr_tpu's."""
    from masr_tpu.infer.predictor import MASRPredictor as JaxPredictor
    from masr_tpu_torch.infer.bundle import save_inference_bundle
    from masr_tpu_torch.infer.predictor import MASRPredictor
    from masr_tpu_torch.models import attention
    from masr_tpu_torch.models.registry import build_model
    from masr_tpu_torch.models.weights import (seeded_state_dict,
                                               to_flax_variables)
    vocab = ["<blank>", "<unk>"] + list("上家音月火少风大你下雪") + ["<eos>"]
    enc = dict(output_size=32, attention_heads=2, linear_units=64,
               num_blocks=2, cnn_module_kernel=7, use_dynamic_chunk=False,
               static_chunk_size=16)
    model = build_model("conformer", 80, len(vocab), streaming=True,
                        encoder_conf=enc, decoder_conf={})
    state = seeded_state_dict(model, 2)
    state["ctc.ctc_lo.weight"] *= 8.0
    save_inference_bundle(str(tmp_path), "conformer", True, 80, vocab,
                          np.full(80, 12.0), np.full(80, 0.3), enc, {}, {},
                          {"feature_method": "fbank", "n_mels": 80},
                          to_flax_variables(state))
    calls, orig = [], attention.RelPositionMultiHeadedAttention._flash

    def spy(self, *a):
        calls.append((threading.current_thread() is threading.main_thread(),
                      torch.is_grad_enabled()))
        return orig(self, *a)

    monkeypatch.setattr(attention.RelPositionMultiHeadedAttention, "_flash",
                        spy)
    pred = MASRPredictor(str(tmp_path), device="cpu", warmup=False)
    srv = _start(pred)
    try:
        raw = _wav_bytes(_render(*SENTENCES[0]), str(tmp_path / "a.wav"))
        status, r = _post(srv, "/recognition", raw)
    finally:
        srv.stop()
    assert status == 200 and calls == [(False, False)] * 2
    want = JaxPredictor(str(tmp_path), warmup=False).predict(raw)
    assert r["result"] == want["text"] and r["result"]


def test_new_entry_points_run_without_jax(tmp_path):
    """With jax, flax and masr_tpu blocked from import: the server CLI
    builds its server on the CPU and answers a long-audio request (the
    port's VAD and its own model file), the export and eval CLIs, the
    punctuation, ITN and model-zoo modules import, and nothing of JAX is
    loaded."""
    import subprocess
    import sys
    import textwrap
    code = textwrap.dedent(f"""
        import json, sys, urllib.request
        class Block:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in ("jax", "jaxlib", "flax",
                                          "masr_tpu"):
                    raise ImportError("blocked: " + name)
        sys.meta_path.insert(0, Block())
        sys.path.insert(0, {REPO!r})
        import numpy as np
        import masr_tpu_torch.eval, masr_tpu_torch.export_model
        import masr_tpu_torch.infer.itn, masr_tpu_torch.infer.model_zoo
        import masr_tpu_torch.infer.punctuation
        from masr_tpu_torch import infer_server
        from masr_tpu_torch.audio.synth_tts import SyntheticTTS
        from masr_tpu_torch.audio.io import write_wave
        srv = infer_server.build_server([
            "--model_dir", {BUNDLE!r}, "--use_gpu", "False", "--host",
            "127.0.0.1", "--port", "{_free_port()}", "--use_pun", "True"])
        srv.start(block=False)
        tts = SyntheticTTS()
        sil = np.zeros(8000, np.float32)
        wav = np.concatenate([sil, tts.render("上家音月火少"), sil,
                              tts.render("蓝右黑真"), sil])
        write_wave("long.wav", wav, 16000)
        req = urllib.request.Request(
            f"http://127.0.0.1:{{srv.port}}/recognition_long_audio",
            data=open("long.wav", "rb").read())
        print(json.loads(urllib.request.urlopen(req).read())["result"])
        srv.stop()
        assert srv.predictor._vad.silero is not None
        assert not any(m.split(".")[0] in ("jax", "flax", "masr_tpu")
                       for m in sys.modules)
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().count("，") == 1
