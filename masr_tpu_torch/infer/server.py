"""ASR server of the PyTorch port (port of masr_tpu/infer/server.py; its
parity surface: reference infer_server.py — REST short/long recognition +
WebSocket streaming).

The reference uses FastAPI+uvicorn; this image has neither, so the REST API
runs on the stdlib ThreadingHTTPServer and streaming runs on the
`websockets` library. Endpoints:

  POST /recognition             multipart or raw audio body → {text, score}
  POST /recognition_long_audio  same, VAD-segmented
  GET  /                        minimal browser demo page
  WS   ws://host:ws_port/       send PCM chunks; 'end' suffix finalizes

Unlike the reference's single-session guard flag (infer_server.py:107 — a
latent race, SURVEY.md §5.2), streaming sessions are serialized with a real
lock per connection and the predictor's stream state is reset between
utterances.

The model runs on the predictor's device. One lock (`_predict_lock`)
serialises every call into the predictor and the engine: the layer
kernels share workspace buffers per module, and the card is one. The
calls come from the HTTP server's handler threads, the WebSocket loop's
thread and asyncio.to_thread workers; the predictor and the engine run
each device call under their own torch.no_grad(), since a new thread
starts with grad mode on.
"""
import asyncio
import json
import re
import threading
import time
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from masr_tpu_torch.utils.logger import setup_logger

logger = setup_logger()


class ServerStats(object):
    """Thread-safe request/stream metrics behind GET /stats (beyond the
    reference, which has no observability endpoint — SURVEY.md §5.5)."""

    def __init__(self, window=512):
        self._lock = threading.Lock()
        self._t0 = time.time()
        self._counts = {}
        self._errors = {}
        self._lat = {}
        self._window = window
        self.streams_active = 0
        self.streams_total = 0
        self.stream_chunks = 0

    def observe(self, endpoint, seconds, ok=True):
        with self._lock:
            self._counts[endpoint] = self._counts.get(endpoint, 0) + 1
            if not ok:
                self._errors[endpoint] = self._errors.get(endpoint, 0) + 1
            self._lat.setdefault(endpoint, deque(maxlen=self._window)) \
                .append(seconds)

    def stream_opened(self):
        with self._lock:
            self.streams_active += 1
            self.streams_total += 1

    def stream_closed(self):
        with self._lock:
            self.streams_active = max(0, self.streams_active - 1)

    def stream_chunk(self):
        with self._lock:
            self.stream_chunks += 1

    def snapshot(self):
        with self._lock:
            endpoints = {}
            for ep, n in self._counts.items():
                lat = sorted(self._lat.get(ep, ()))
                pct = (lambda q: round(
                    lat[min(int(q * len(lat)), len(lat) - 1)] * 1000, 2)) \
                    if lat else (lambda q: None)
                endpoints[ep] = {"count": n,
                                 "errors": self._errors.get(ep, 0),
                                 "p50_ms": pct(0.50), "p90_ms": pct(0.90)}
            return {"uptime_s": round(time.time() - self._t0, 1),
                    "endpoints": endpoints,
                    "streaming": {"active": self.streams_active,
                                  "sessions_total": self.streams_total,
                                  "chunks_total": self.stream_chunks}}

# Browser client — feature parity with the reference's recording UI
# (reference templates/index.html:1-150 + static/record.js:1-207): short
# and long file upload with an XHR progress bar, and a one-button
# microphone toggle that streams 16 kHz int16 PCM over the WebSocket and
# renders partial transcripts live. Served inline (no static/ dir); the
# record button flips color instead of swapping a gif.
INDEX_HTML = """<!doctype html>
<html lang="zh"><head><meta charset="utf-8">
<meta name="viewport" content="width=device-width, initial-scale=1">
<title>masr_tpu 语音识别</title>
<style>
 body{font-family:sans-serif;max-width:720px;margin:24px auto;padding:0 12px}
 #header h1{text-align:center;font-weight:500}
 .file{display:inline-block;padding:9px 18px;background:#2f7bd9;color:#fff;
       border-radius:4px;cursor:pointer;margin-right:10px;user-select:none}
 .file:hover{background:#2565b6}
 #record_btn{display:inline-block;width:46px;height:46px;border-radius:50%;
       background:#d9534f;vertical-align:middle;cursor:pointer;border:none}
 #record_btn.recording{background:#7a1f1c;animation:pulse 1s infinite}
 @keyframes pulse{50%{opacity:.5}}
 #result_p{width:100%;height:160px;margin-top:16px;font-size:15px}
 progress{width:70%}
</style></head>
<body>
<div id="header"><h1>masr_tpu 语音识别</h1></div>
<div id="content">
  <div>
    <a id="upload" onclick="uploadAudioFile()" class="file">短音频文件识别</a>
    <a id="upload_long" onclick="uploadLongAudioFile()" class="file">长音频文件识别</a>
    <button id="record_btn" onclick="record()" title="录音"></button>
  </div>
  <div id="result"><textarea id="result_p" readonly></textarea></div>
  上传进度：<progress id="progress1" value="0" max="100"></progress>&nbsp;
  <span id="progress_text"></span>
</div>
<script>
const WS_PORT = location.port ? (parseInt(location.port) + 1) : 5001;
const textarea = document.getElementById('result_p');
const progress1 = document.getElementById('progress1');
const progress_text = document.getElementById('progress_text');

// ---- file upload with progress (reference index.html:60-150) ----
function upload_file(url, file, callback) {
  const fd = new FormData();
  fd.append('audio', file);
  const xhr = new XMLHttpRequest();
  xhr.timeout = 120000;
  xhr.upload.addEventListener('progress', e => callback('uploading', e));
  xhr.addEventListener('load', e => callback('ok', e));
  xhr.addEventListener('error', e => callback('error', e));
  xhr.addEventListener('abort', e => callback('cancel', e));
  xhr.open('POST', url);
  xhr.send(fd);
}
function pickAndUpload(url, accept) {
  const input = document.createElement('input');
  input.type = 'file';
  input.accept = accept;
  input.click();
  input.onchange = () => {
    const file = input.files[0];
    upload_file(url, file, (state, e) => {
      switch (state) {
        case 'uploading': {
          const pct = Math.round(e.loaded * 100 / e.total);
          progress1.value = pct;
          progress_text.innerText = pct + '%';
          break;
        }
        case 'ok': {
          try {
            const r = JSON.parse(e.target.responseText);
            textarea.value = r.code === 0
              ? r.result + '\\n(得分 ' + r.score + ')' : e.target.responseText;
          } catch (_) { textarea.value = e.target.responseText; }
          break;
        }
        case 'error': alert('上传失败'); break;
        case 'cancel': alert('上传被取消'); break;
      }
    });
  };
}
function uploadAudioFile() { pickAndUpload('/recognition', 'audio/*'); }
function uploadLongAudioFile() {
  pickAndUpload('/recognition_long_audio', 'audio/*');
}

// ---- microphone streaming (reference record.js, AudioContext-native:
// the browser resamples to 16 kHz instead of record.js's decimation) ----
let ctx = null, ws = null, node = null, stream = null, is_recording = false;
function record() { is_recording ? stopRecording() : startRecording(); }
async function startRecording() {
  stream = await navigator.mediaDevices.getUserMedia({audio: {
    sampleRate: 16000, channelCount: 1}});
  ctx = new AudioContext({sampleRate: 16000});
  ws = new WebSocket(`ws://${location.hostname}:${WS_PORT}/`);
  ws.onmessage = (e) => {
    const msg = JSON.parse(e.data);
    textarea.value = (msg.is_end ? '[final] ' : '') + msg.result;
  };
  const src = ctx.createMediaStreamSource(stream);
  node = ctx.createScriptProcessor(4096, 1, 1);
  node.onaudioprocess = (e) => {
    if (ws.readyState !== 1) return;
    const f32 = e.inputBuffer.getChannelData(0);
    const i16 = new Int16Array(f32.length);
    for (let i = 0; i < f32.length; i++)
      i16[i] = Math.max(-32768, Math.min(32767, f32[i] * 32768));
    ws.send(i16.buffer);
  };
  src.connect(node); node.connect(ctx.destination);
  is_recording = true;
  document.getElementById('record_btn').classList.add('recording');
}
async function stopRecording() {
  node.disconnect();
  stream.getTracks().forEach(t => t.stop());
  ws.send(new Uint8Array([101, 110, 100]));  // "end"
  await ctx.close();
  ctx = null;
  is_recording = false;
  document.getElementById('record_btn').classList.remove('recording');
}
</script></body></html>"""


class ASRServer(object):
    def __init__(self, predictor, host="0.0.0.0", port=5000, ws_port=None,
                 use_pun=False, is_itn=False, max_streams=0,
                 tick_chunks=1, pos_table_len=8192):
        """max_streams > 1 serves that many CONCURRENT WebSocket streams
        through the batched engine (masr_tpu_torch.infer.batch_stream):
        one batched chunk step per tick, per-connection slots.
        max_streams <= 1 keeps the single-predictor path; a second
        concurrent streaming connection is rejected with a busy error
        (the reference's never-enforced `running` guard, infer_server.py:
        107, enforced for real — interleaving two streams into one
        predictor state would corrupt both)."""
        self.predictor = predictor
        self.host = host
        self.port = port
        self.ws_port = ws_port if ws_port is not None else port + 1
        self.use_pun = use_pun
        self.is_itn = is_itn
        self._predict_lock = threading.Lock()  # predictor is not reentrant
        self.stats = ServerStats()
        self._httpd = None
        self._stream_busy = False
        self.batch_session = None
        if max_streams and max_streams > 1:
            from masr_tpu_torch.infer.batch_stream import \
                BatchStreamSession
            # with a beam-configured predictor, batched streams decode via
            # the on-device batched beam search (one program for all
            # slots); greedy predictors keep the host greedy carry
            stream_decoder = "ctc_beam_search_device" \
                if predictor.decoder in ("ctc_beam_search",
                                         "attention_rescoring",
                                         "ctc_beam_search_device") \
                else "ctc_greedy"
            # carry the predictor's device-beam conf (incl. the fused LM
            # table) into the batched engine when it has one
            conf = dict(predictor._device_beam_conf or {}) \
                if getattr(predictor, "_device_beam_conf", None) else {}
            self.batch_session = BatchStreamSession(
                predictor.predictor, predictor._vocab_list,
                preprocess_conf=dict(
                    predictor.predictor.meta.get("preprocess_conf") or {}),
                max_streams=max_streams, decoder=stream_decoder,
                decoder_conf=conf,
                tick_chunks=tick_chunks, pos_table_len=pos_table_len)

    # ------------------------------ REST ------------------------------- #
    def _make_handler(server):
        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):
                logger.info("HTTP " + fmt % args)

            def _send_json(self, code, payload):
                body = json.dumps(payload, ensure_ascii=False).encode("utf-8")
                self.send_response(code)
                self.send_header("Content-Type",
                                 "application/json; charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _read_audio(self):
                ctype = self.headers.get("Content-Type", "")
                length = int(self.headers.get("Content-Length", 0))
                if length == 0:
                    return None
                body = self.rfile.read(length)
                if ctype.startswith("multipart/form-data"):
                    m = re.search(r'boundary="?([^";]+)"?', ctype)
                    if not m:
                        return None
                    boundary = m.group(1).encode()
                    for part in body.split(b"--" + boundary):
                        if b"\r\n\r\n" not in part:
                            continue
                        headers, _, content = part.partition(b"\r\n\r\n")
                        if b"filename=" in headers or b'name="audio"' in \
                                headers or b'name="file"' in headers:
                            # part content ends with exactly one CRLF before
                            # the next boundary; don't strip payload bytes
                            if content.endswith(b"\r\n"):
                                content = content[:-2]
                            return content
                    return None
                return body

            def do_GET(self):
                if self.path in ("/", "/index.html"):
                    body = INDEX_HTML.encode("utf-8")
                    self.send_response(200)
                    self.send_header("Content-Type",
                                     "text/html; charset=utf-8")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                elif self.path == "/stats":
                    self._send_json(200, server.stats.snapshot())
                else:
                    self._send_json(404, {"code": 404, "msg": "not found"})

            def do_POST(self):
                t0 = time.perf_counter()
                try:
                    data = self._read_audio()
                    if not data:
                        server.stats.observe(
                            self.path, time.perf_counter() - t0, ok=False)
                        self._send_json(400, {"code": 400,
                                              "msg": "no audio provided"})
                        return
                    with server._predict_lock:
                        if self.path == "/recognition":
                            result = server.predictor.predict(
                                data, use_pun=server.use_pun,
                                is_itn=server.is_itn)
                        elif self.path == "/recognition_long_audio":
                            result = server.predictor.predict_long(
                                data, use_pun=server.use_pun,
                                is_itn=server.is_itn)
                        else:
                            server.stats.observe(
                                self.path, time.perf_counter() - t0,
                                ok=False)
                            self._send_json(404, {"code": 404,
                                                  "msg": "not found"})
                            return
                    server.stats.observe(self.path,
                                         time.perf_counter() - t0)
                    self._send_json(200, {"code": 0, "msg": "success",
                                          "result": result["text"],
                                          "score": result["score"]})
                except Exception as e:
                    server.stats.observe(self.path,
                                         time.perf_counter() - t0, ok=False)
                    logger.exception("recognition failed")
                    self._send_json(500, {"code": 500, "msg": str(e)})

        return Handler

    # --------------------------- WebSocket ----------------------------- #
    # ---------------- batched multi-stream WS path -------------------- #
    def _feed_slot(self, slot, samples, is_end):
        with self._predict_lock:
            return self.batch_session.feed(slot, samples, is_end=is_end)

    async def _ws_handler_batched(self, websocket):
        import asyncio as aio
        with self._predict_lock:
            try:
                slot = self.batch_session.open()
            except RuntimeError as e:
                slot = None
                err = str(e)
        if slot is None:
            await websocket.send(json.dumps({"code": 1, "msg": err},
                                            ensure_ascii=False))
            await websocket.close()
            return
        logger.info(f"websocket session from {websocket.remote_address} "
                    f"→ stream slot {slot}")
        self.stats.stream_opened()

        async def finish(result):
            nonlocal slot
            final = result or {"text": "", "score": 0.0}
            await websocket.send(json.dumps(
                {"code": 0, "is_end": True, "result": final["text"],
                 "score": final.get("score")}, ensure_ascii=False))
            # fresh state for the next utterance on this connection
            with self._predict_lock:
                self.batch_session.close(slot)
                slot = self.batch_session.open()

        try:
            async for message in websocket:
                if isinstance(message, (bytes, bytearray)):
                    self.stats.stream_chunk()
                    is_end = message.endswith(b"end")
                    payload = message[:-3] if is_end else bytes(message)
                    samples = (np.frombuffer(payload, np.int16)
                               .astype(np.float32) / 32768.0) if payload \
                        else np.zeros(0, np.float32)
                    result = await aio.to_thread(self._feed_slot, slot,
                                                 samples, is_end)
                    if is_end:
                        await finish(result)
                    elif result is not None:
                        await websocket.send(json.dumps(
                            {"code": 0, "is_end": False,
                             "result": result["text"]}, ensure_ascii=False))
                elif message == "end":
                    result = await aio.to_thread(
                        self._feed_slot, slot, np.zeros(160, np.float32),
                        True)
                    await finish(result)
        except Exception as e:
            logger.warning(f"websocket session ended: {e}")
        finally:
            self.stats.stream_closed()
            with self._predict_lock:
                self.batch_session.close(slot)

    async def _ws_handler(self, websocket):
        if self.batch_session is not None:
            await self._ws_handler_batched(websocket)
            return
        # single-predictor path: enforce one streaming session at a time
        # (two interleaved streams would corrupt one shared stream state)
        with self._predict_lock:
            busy = self._stream_busy
            if not busy:
                self._stream_busy = True
        if busy:
            await websocket.send(json.dumps(
                {"code": 1, "msg": "busy: another streaming session is "
                                   "active; start the server with "
                                   "--max_streams N for concurrency"},
                ensure_ascii=False))
            await websocket.close()
            return
        logger.info(f"websocket session from {websocket.remote_address}")
        self.stats.stream_opened()
        try:
            async for message in websocket:
                if isinstance(message, (bytes, bytearray)):
                    self.stats.stream_chunk()
                    is_end = message.endswith(b"end")
                    payload = message[:-3] if is_end else bytes(message)
                    with self._predict_lock:
                        result = self.predictor.predict_stream(
                            payload, is_end=is_end, use_pun=self.use_pun,
                            is_itn=self.is_itn) if payload else None
                        if is_end:
                            final = result or {"text": "", "score": 0.0}
                            self.predictor.reset_stream()
                            await websocket.send(json.dumps(
                                {"code": 0, "is_end": True,
                                 "result": final["text"],
                                 "score": final.get("score")},
                                ensure_ascii=False))
                            continue
                    if result is not None:
                        await websocket.send(json.dumps(
                            {"code": 0, "is_end": False,
                             "result": result["text"]}, ensure_ascii=False))
                elif message == "end":
                    with self._predict_lock:
                        result = self.predictor.predict_stream(
                            np.zeros(160, np.float32).tobytes(), is_end=True,
                            use_pun=self.use_pun, is_itn=self.is_itn)
                        self.predictor.reset_stream()
                    final = result or {"text": "", "score": 0.0}
                    await websocket.send(json.dumps(
                        {"code": 0, "is_end": True, "result": final["text"],
                         "score": final.get("score")}, ensure_ascii=False))
        except Exception as e:
            logger.warning(f"websocket session ended: {e}")
        finally:
            self.stats.stream_closed()
            with self._predict_lock:
                self.predictor.reset_stream()
                self._stream_busy = False

    async def _serve_ws(self):
        import websockets
        async with websockets.serve(self._ws_handler, self.host, self.ws_port):
            logger.info(f"websocket streaming on ws://{self.host}:{self.ws_port}/")
            await asyncio.Future()

    # ------------------------------ run -------------------------------- #
    def start(self, block=True):
        self._httpd = ThreadingHTTPServer((self.host, self.port),
                                          self._make_handler())
        http_thread = threading.Thread(target=self._httpd.serve_forever,
                                       daemon=True)
        http_thread.start()
        logger.info(f"REST API on http://{self.host}:{self.port}/")
        if block:
            try:
                asyncio.run(self._serve_ws())
            except KeyboardInterrupt:
                pass
            finally:
                self._httpd.shutdown()
        else:
            ws_thread = threading.Thread(
                target=lambda: asyncio.run(self._serve_ws()), daemon=True)
            ws_thread.start()
        return self

    def stop(self):
        if self._httpd is not None:
            self._httpd.shutdown()
