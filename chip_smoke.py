#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (masr_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's offline and streaming recognition paths through their
public entry points (MASRPredictor.predict_batch, MASRPredictor.
predict_stream, BatchStreamSession) and holds every hand-written kernel of
those paths against its plain PyTorch twin. Phases, one JSON line each:

  1. build          compile the CUDA sources of the repo (nvcc, sm_90a), one
                    process per source, all started together
  2. kernels        the full-context Conformer layer kernel vs its plain twin
                    at flagship width (D=256, 4 heads, FFN 2048, conv 15),
                    B=4, T' in {37, 299, 1500}, causal and not
  3. flagship       12-block flagship model (configs/conformer.yml widths,
                    vocabulary 4000) with weights drawn from a seed:
                    predict_batch of 8 synthetic utterances (2-12 s) on the
                    card, where every layer must launch the kernel, against
                    the same model on the CPU (the plain twin)
  4. bundle         the trained example bundle (examples/tiny_zh_synth) on
                    the card: held-out sentences, same text as on the CPU
  5. times          one flagship layer at the main path's shape (B=8,
                    T'=299): kernel vs plain, checked and timed with CUDA
                    events; and the wall time of flagship predict_batch
  6. chunk_kernels  the streaming chunk-layer kernel vs its plain twin at
                    flagship width: B=32 slots, c=16, C=256 with cache_len
                    {0, 5, 100, 256}, other write pointers and offsets and
                    four inactive slots (their caches must stay bitwise
                    unchanged), table and exact positions, n_sub=2 at c=32,
                    and B=1 (predict_stream's shape)
  7. stream         the flagship weights through predict_stream on the card,
                    both frontends, fed whole and in 0.2 s pieces (same
                    text), against the same bundle on the CPU; every layer
                    of every window must launch the chunk kernel. This
                    bundle turns dB normalization off: its gain is taken
                    over each call's buffer, so with it on, a model with
                    random weights may read the two feedings differently
  8. engine         BatchStreamSession(max_streams=32) on the card, fed with
                    feed_many, 32 staggered streams (the 8 utterances, 4
                    times): each text equals the port's own predict_stream
                    text; 12 launches per dispatch; 4 slots on the CPU
                    engine; a tiny position table whose horizon the streams
                    cross (exact-positions dispatches), same texts
  9. bundle_stream  the example bundle through predict_stream: card text ==
                    CPU text, held-out sentences recognised
 10. stream_times   chunk kernel vs plain at B=32, c=16, C=256 (CUDA
                    events); engine tick wall at 32 active slots and its
                    real-time factor; predict_stream window latency at B=1

A text that differs between two runs fails only where the first differing
frame's top-2 margin exceeds 1e-3 (a near-tie that f32 sums in another
order may flip). Then the kernels line, the card's name and power limit, and
last {"ok": true, "device": {...}}. Any failed check raises: the script
exits non-zero and prints no result. It needs CUDA and the repository's
package beside it; it imports nothing of JAX.
"""
import contextlib
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, "build", "smoke")
TINY_BUNDLE = os.path.join(REPO, "examples", "tiny_zh_synth",
                           "inference_model")
# configs/conformer.yml encoder_conf; streaming: True → causal conv
FLAGSHIP_ENCODER = dict(output_size=256, attention_heads=4, linear_units=2048,
                        num_blocks=12, dropout_rate=0.1,
                        positional_dropout_rate=0.1,
                        attention_dropout_rate=0.1, input_layer="conv2d",
                        normalize_before=True, cnn_module_kernel=15,
                        use_cnn_module=True, activation_type="swish",
                        pos_enc_layer_type="rel_pos")
PREPROCESS = dict(feature_method="fbank", n_mels=80, n_mfcc=40,
                  sample_rate=16000, use_dB_normalization=True, target_dB=-20)
VOCAB = 4000                                          # bench.py:61
# the bundle's first three held-out sentences (tools/head_to_head.py
# make_corpus(240, 24)) and their speakers, as tests/test_example_bundle.py
HELD_OUT = [("上家音月火少", 0), ("风大你火下雪", 1), ("蓝右黑真", 0)]

KERNEL_ATOL = 2e-4        # f32 FMA vs f32 PyTorch, different sum order
PROBS_ATOL = 1e-4         # 12 such layers + CTC softmax, card vs CPU
ARGMAX_MARGIN = 1e-3
# the streaming path (masr_tpu_torch/infer/predictor.py): 16 output frames
# per window, 16 left chunks of cache, windows of 67 frames every 0.64 s
CHUNK, CACHE = 16, 256
PIECE = 3200                               # 0.2 s of 16 kHz audio
STRIDE_SAMPLES = 10240                     # 0.64 s: one window further
FIRST_WINDOW_SAMPLES = 10960               # 67 frames of 25 ms every 10 ms
ENGINE_STREAMS = 32
# H100 SXM data sheet, dense, at its 700 W limit: f32 outside the tensor
# cores, HBM3 bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_S = 3.35e12


def emit(obj):
    print(json.dumps(obj, ensure_ascii=False), flush=True)


def check(ok, what):
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def card():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def seeded_layer(seed, causal, device):
    from masr_tpu_torch.models.conformer import ConformerEncoderLayer
    from masr_tpu_torch.models.weights import seeded_state_dict
    e = FLAGSHIP_ENCODER
    layer = ConformerEncoderLayer(e["output_size"], e["attention_heads"],
                                  e["linear_units"], e["cnn_module_kernel"],
                                  causal)
    layer.load_state_dict(seeded_state_dict(layer, seed))
    return layer.to(device).eval()


def layer_inputs(layer, lens, T, seed, device):
    from masr_tpu_torch.models.embedding import sinusoid_position_encoding
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(len(lens), T, layer.size, generator=g).to(device)
    lens = torch.tensor(lens, dtype=torch.int32, device=device)
    pos = sinusoid_position_encoding(torch.arange(T, device=device),
                                     layer.size)
    with torch.no_grad():
        pos_p = layer.self_attn.linear_pos(pos)
    return x, lens, pos_p


def run_layer(fn, layer, x, lens, pos_p):
    return fn(x, lens, pos_p, layer.packed_params(),
              n_head=layer.attention_heads, ksize=layer.cnn_module_kernel,
              causal=layer.causal)


def phase_kernels(dev):
    from masr_tpu_torch.ops.cuda import conformer_layer as cl
    cases, worst = [], 0.0
    for T in (37, 299, 1500):
        lens = [T, T - 17, 5, 0]
        for causal in (True, False):
            layer = seeded_layer(T, causal, dev)
            x, lens_t, pos_p = layer_inputs(layer, lens, T, T + 1, dev)
            with torch.no_grad():
                got = run_layer(cl.fused_conformer_layer, layer, x, lens_t,
                                pos_p)
                want = run_layer(cl.fused_conformer_layer_plain, layer, x,
                                 lens_t, pos_p)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(got).all()),
                  f"kernel output finite (T'={T}, causal={causal})")
            err = max((got[b, :n] - want[b, :n]).abs().max().item()
                      for b, n in enumerate(lens) if n)
            check(err <= KERNEL_ATOL, f"kernel vs plain max abs err {err} "
                  f"<= {KERNEL_ATOL} (T'={T}, causal={causal})")
            cases.append({"T": T, "lens": lens, "causal": causal,
                          "max_abs_err": err})
            worst = max(worst, err)
    emit({"phase": "kernels", "kernel": "fused_conformer_layer", "B": 4,
          "D": 256, "heads": 4, "ffn": 2048, "conv_kernel": 15,
          "atol": KERNEL_ATOL, "cases": cases})
    return worst


def write_flagship_bundle(path):
    """A flagship bundle with weights drawn from seed 0, written the way
    masr_tpu's exporter writes one (flax msgpack), CMVN from the example
    bundle (same fbank frontend)."""
    from masr_tpu_torch.infer import flax_msgpack
    from masr_tpu_torch.models.registry import build_model
    from masr_tpu_torch.models.weights import (seeded_state_dict,
                                               to_flax_variables)
    with open(os.path.join(TINY_BUNDLE, "inference.json"),
              encoding="utf-8") as f:
        tiny = json.load(f)
    model = build_model("conformer", 80, VOCAB, streaming=True,
                        encoder_conf=FLAGSHIP_ENCODER)
    state = seeded_state_dict(model, seed=0)
    # CTC head ×8: the frame posteriors peak as a trained model's do; at
    # the default init they sit near 1/V, and no frame would have a top-2
    # margin for the argmax comparison
    state["ctc.ctc_lo.weight"] *= 8.0
    variables = to_flax_variables(state)
    meta = {"framework": "masr_tpu", "use_model": "conformer",
            "streaming": True, "input_dim": 80, "vocab_size": VOCAB,
            "mean": tiny["mean"], "istd": tiny["istd"],
            "encoder_conf": FLAGSHIP_ENCODER, "decoder_conf": {},
            "model_conf": {}, "preprocess_conf": PREPROCESS,
            "quantization": None}
    vocab = (["<blank>", "<unk>"] + [chr(0x4e00 + i) for i in range(VOCAB - 3)]
             + ["<eos>"])
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "inference.json"), "w",
              encoding="utf-8") as f:
        json.dump(meta, f, ensure_ascii=False)
    with open(os.path.join(path, "vocabulary.txt"), "w",
              encoding="utf-8") as f:
        f.writelines(tok + "\t-1\n" for tok in vocab)
    with open(os.path.join(path, "model.msgpack"), "wb") as f:
        f.write(flax_msgpack.packb(variables))
    return vocab


def synthetic_utterances(vocab):
    """8 utterances of 10..59 characters: 2.1 s to 11.9 s of audio."""
    from masr_tpu_torch.audio.synth_tts import SyntheticTTS
    tts = SyntheticTTS(sample_rate=16000)
    rs = np.random.RandomState(1)
    wavs = []
    for i, n in enumerate(np.linspace(10, 59, 8).astype(int)):
        text = "".join(vocab[j] for j in rs.randint(2, len(vocab) - 1, n))
        wavs.append(tts.render(text, spk_id=i))
    return wavs


def phase_flagship(dev):
    from masr_tpu_torch.infer.predictor import MASRPredictor
    from masr_tpu_torch.ops.cuda import conformer_layer as cl
    path = os.path.join(WORK, "flagship_bundle")
    wavs = synthetic_utterances(write_flagship_bundle(path))
    gpu = MASRPredictor(model_dir=path, device=dev)
    # the main path: counts read around predict_batch alone
    cl.fused_conformer_layer.launches = 0
    t0 = time.perf_counter()
    texts = gpu.predict_batch(wavs)
    wall = time.perf_counter() - t0
    launches = cl.fused_conformer_layer.launches
    n_layers = FLAGSHIP_ENCODER["num_blocks"]
    check(launches == n_layers, f"kernel launches {launches} == "
          f"{n_layers} layers x 1 encoder call")
    cpu = MASRPredictor(model_dir=path, device="cpu", warmup=False)
    speech, lens = gpu.featurize_batch(wavs)
    p_gpu, l_gpu = gpu.predictor.predict(speech, lens)
    p_cpu, l_cpu = cpu.predictor.predict(speech, lens)
    check(p_gpu.shape == p_cpu.shape and p_gpu.shape[0] == len(wavs)
          and p_gpu.shape[2] == VOCAB, f"probs shape {p_gpu.shape}")
    check((l_gpu == l_cpu).all(), "encoder lengths card == CPU")
    check(np.isfinite(p_gpu).all(), "probs finite")
    err, flips, compared = 0.0, 0, 0
    for b, n in enumerate(l_cpu):
        g, c = p_gpu[b, :n], p_cpu[b, :n]
        err = max(err, float(np.abs(g - c).max()))
        top2 = np.sort(c, axis=-1)[:, -2:]
        sure = top2[:, 1] - top2[:, 0] > ARGMAX_MARGIN
        flips += int((g.argmax(-1) != c.argmax(-1))[sure].sum())
        compared += int(sure.sum())
    check(err <= PROBS_ATOL, f"probs card vs CPU {err} <= {PROBS_ATOL}")
    check(flips == 0, f"{flips} argmax flips where top-2 margin > "
          f"{ARGMAX_MARGIN}")
    cpu_texts = cpu.predict_batch(wavs)
    emit({"phase": "flagship", "utterances": len(wavs),
          "seconds_audio": [round(len(w) / 16000, 3) for w in wavs],
          "T_out": int(p_gpu.shape[1]), "launches": launches,
          "probs_max_abs_err": err, "probs_atol": PROBS_ATOL,
          "argmax_frames_compared": compared,
          "texts_equal_cpu": sum(a["text"] == b["text"]
                                 for a, b in zip(texts, cpu_texts)),
          "predict_batch_s": wall})
    return gpu, wavs, launches


def phase_bundle(dev):
    from masr_tpu_torch.audio.synth_tts import SyntheticTTS
    from masr_tpu_torch.infer.predictor import MASRPredictor
    tts = SyntheticTTS(sample_rate=16000)
    gpu = MASRPredictor(model_dir=TINY_BUNDLE, device=dev)
    cpu = MASRPredictor(model_dir=TINY_BUNDLE, device="cpu", warmup=False)
    rows = []
    for text, spk in HELD_OUT:
        wav = tts.render(text, spk_id=spk)
        rows.append((text, gpu.predict(wav)["text"], cpu.predict(wav)["text"]))
    exact = sum(want == got for want, got, _ in rows)
    check(exact >= 2, f"bundle decoded {exact}/3 held-out sentences")
    check(all(got == ref for _, got, ref in rows), "card text == CPU text")
    emit({"phase": "bundle", "exact": exact, "of": len(rows),
          "texts": [got for _, got, _ in rows]})


def cuda_ms(fn, iters=20):
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_times(dev, gpu, wavs, smi):
    from masr_tpu_torch.ops.cuda import conformer_layer as cl
    T, lens = 299, [299] * 8
    layer = seeded_layer(7, True, dev)
    x, lens_t, pos_p = layer_inputs(layer, lens, T, 8, dev)

    def kernel():
        return run_layer(cl.fused_conformer_layer, layer, x, lens_t, pos_p)

    def plain():
        return run_layer(cl.fused_conformer_layer_plain, layer, x, lens_t,
                         pos_p)

    with torch.no_grad():
        # the timed shape is the main path's: hold it against plain too
        err = (kernel() - plain()).abs().max().item()
        check(err <= KERNEL_ATOL, f"kernel vs plain max abs err {err} <= "
              f"{KERNEL_ATOL} (B=8, T'={T})")
        # plain, kernel, kernel, plain
        runs = {"plain": [cuda_ms(plain)], "kernel": [cuda_ms(kernel)]}
        runs["kernel"].append(cuda_ms(kernel))
        runs["plain"].append(cuda_ms(plain))
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        gpu.predict_batch(wavs)
        walls.append(time.perf_counter() - t0)
    ms = float(np.mean(runs["kernel"]))
    plain_ms = float(np.mean(runs["plain"]))
    bound = layer_bound(layer, lens, T)
    emit({"phase": "times", "card": smi, "layer": {"B": 8, "T": T, "D": 256,
          "ffn": 2048, "max_abs_err": err, "kernel_ms": runs["kernel"],
          "plain_ms": runs["plain"], **bound}, "predict_batch_s": walls,
          "predict_batch_audio_s": round(sum(len(w) for w in wavs) / 16000,
                                         3)})
    return ms, plain_ms, err, bound


# --------------------------------------------------------------------------- #
# bounds: the least time the card could take for a kernel call's work
# --------------------------------------------------------------------------- #
def _bound(flops, nbytes):
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_S
    return {"gflop": flops / 1e9, "mbytes": nbytes / 1e6,
            "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def _weight_bytes(layer):
    return 4 * sum(t.numel() for t in layer.packed_params().values())


def layer_bound(layer, lens, T):
    """Full-context layer over valid rows: matmuls, rel-pos attention over
    the valid keys, depthwise conv (f32); bytes: packed weights, x in,
    out, pos_p, each once."""
    D, F, K = layer.size, layer.feed_forward.w_1.out_features, \
        layer.cnn_module_kernel
    M = sum(lens)
    flops = (8 * M * D * F + 8 * M * D * D        # FFN x2, q/k/v/out
             + 6 * M * D * D                      # pw1 (D -> 2D), pw2
             + 2 * M * D * K                      # depthwise
             + sum(6 * D * n * n for n in lens))  # [q+u|q+v].[k|p], AV
    nbytes = _weight_bytes(layer) + 4 * (2 * len(lens) * T * D + T * D)
    return _bound(flops, nbytes)


def chunk_bound(layer, clens, active, c, C):
    """One chunk-layer call (n_sub = 1) over B slots: matmuls over B*c rows
    (pw1 over the k-1+c conv-input rows), attention of each slot over its
    cache_len valid cache keys and the c chunk keys; bytes: packed weights,
    x in and out, the valid cache rows read, the fresh rows and cnn caches
    of active slots written, each slot's position window, cnn caches
    read."""
    D, F, K = layer.size, layer.feed_forward.w_1.out_features, \
        layer.cnn_module_kernel
    B = len(clens)
    M, W = B * c, K - 1 + c
    flops = (8 * M * D * F + 8 * M * D * D + 4 * B * W * D * D
             + 2 * M * D * D + 2 * M * D * K
             + sum(6 * D * c * (n + c) for n in clens))
    n_act = sum(bool(a) for a in active)
    nbytes = _weight_bytes(layer) + 4 * (
        2 * M * D                                 # x in, out
        + sum(clens) * 2 * D                      # valid [K|V] cache rows
        + n_act * min(c, C) * 2 * D               # fresh rows written
        + B * (C + c) * D                         # position windows
        + (B + n_act) * (K - 1) * D)              # cnn caches in, out
    return _bound(flops, nbytes)


# --------------------------------------------------------------------------- #
# streaming: the chunk-layer kernel, predict_stream, BatchStreamSession
# --------------------------------------------------------------------------- #
def chunk_inputs(layer, B, c, clens, wptrs, offsets, active, route, seed,
                 dev, table_len=8192):
    """Arguments of fused_chunk_layer for one flagship layer: a random
    chunk and caches from `seed`, positions from the per-layer table at
    the slots' offsets or exact (one window of rows per slot)."""
    from masr_tpu_torch.models.embedding import sinusoid_position_encoding
    from masr_tpu_torch.ops.cuda import chunk_layer as ck
    D, H = layer.size, layer.attention_heads
    K1, L = layer.cnn_module_kernel - 1, CACHE + c
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(B, c, D, generator=g).to(dev)
    att = (0.5 * torch.randn(B, H, CACHE, 2 * D // H, generator=g)).to(dev)
    cnn = (0.5 * torch.randn(B, K1, D, generator=g)).to(dev)

    def i32(v):
        return torch.tensor(v, dtype=torch.int32, device=dev)

    with torch.no_grad():
        if route == "table":
            pos = ck.make_chunk_pos_table(layer.self_attn.linear_pos.weight,
                                          CACHE, table_len)
            starts = ck.clamp_pos_starts(i32(offsets), table_len, L)
        else:
            rows = torch.clamp(i32(offsets)[:, None].long() - CACHE
                               + torch.arange(L, device=dev), min=0)
            pos = layer.self_attn.linear_pos(
                sinusoid_position_encoding(rows.reshape(-1), D))
            starts = torch.arange(B, dtype=torch.int32, device=dev) * L
    return (x, pos, starts, att, cnn, i32(clens), i32(wptrs), i32(active),
            layer.packed_params())


def run_chunk(fn, layer, args, n_sub=1):
    x, pos, starts, att, cnn, clens, wptrs, active, packed = args
    return fn(x, pos, starts, att, cnn, clens, wptrs, active, packed,
              n_head=layer.attention_heads, ksize=layer.cnn_module_kernel,
              n_sub=n_sub)


def phase_chunk_kernels(dev):
    from masr_tpu_torch.ops.cuda import chunk_layer as ck
    layer = seeded_layer(11, True, dev)
    cases, worst = [], 0.0
    for B, c, n_sub, route in ((32, 16, 1, "table"), (32, 16, 1, "exact"),
                               (32, 32, 2, "table"), (1, 16, 1, "exact")):
        clens = [(0, 5, 100, CACHE)[s % 4] for s in range(B)]
        wptrs = [(37 * s) % CACHE for s in range(B)]
        offsets = [n + 16 * s if n else 0 for s, n in enumerate(clens)]
        active = [0 if s in (3, 10, 17, 29) else 1 for s in range(B)]
        args = chunk_inputs(layer, B, c, clens, wptrs, offsets, active,
                            route, B + c, dev)
        att0, cnn0 = args[3], args[4]
        with torch.no_grad():
            got = {}
            for name, fn in (("kernel", ck.fused_chunk_layer),
                             ("plain", ck.fused_chunk_layer_plain)):
                a = args[:3] + (att0.clone(), cnn0.clone()) + args[5:]
                got[name] = (run_chunk(fn, layer, a, n_sub), a[3], a[4])
        torch.cuda.synchronize()
        (y, att_k, cnn_k), (y_p, att_p, cnn_p) = got["kernel"], got["plain"]
        check(bool(torch.isfinite(y).all()), f"chunk kernel output finite "
              f"(B={B}, c={c}, {route})")
        err = max((a - b).abs().max().item()
                  for a, b in ((y, y_p), (att_k, att_p), (cnn_k, cnn_p)))
        check(err <= KERNEL_ATOL, f"chunk kernel vs plain max abs err {err} "
              f"<= {KERNEL_ATOL} (B={B}, c={c}, n_sub={n_sub}, {route})")
        off = torch.tensor(active, device=dev) == 0
        check(torch.equal(att_k[off], att0[off])
              and torch.equal(cnn_k[off], cnn0[off]),
              "inactive slots' att and cnn caches bitwise unchanged")
        cases.append({"B": B, "c": c, "n_sub": n_sub, "route": route,
                      "inactive": int(off.sum()), "max_abs_err": err})
        worst = max(worst, err)
    emit({"phase": "chunk_kernels", "kernel": "fused_chunk_layer",
          "C": CACHE, "D": 256, "heads": 4, "ffn": 2048, "conv_kernel": 15,
          "cache_lens": [0, 5, 100, CACHE], "atol": KERNEL_ATOL,
          "cases": cases})
    return worst


def reset_launches():
    from masr_tpu_torch.ops.cuda import chunk_layer as ck
    from masr_tpu_torch.ops.cuda import conformer_layer as cl
    ck.fused_chunk_layer.launches = 0
    cl.fused_conformer_layer.launches = 0


def chunk_launches():
    from masr_tpu_torch.ops.cuda import chunk_layer as ck
    return ck.fused_chunk_layer.launches


@contextlib.contextmanager
def record_top2(store):
    """Appends the top-2 probs (B, T, 2) of every greedy head call, from the
    single stream and the engine, to `store`."""
    from masr_tpu_torch.infer import batch_stream, inference_model
    orig = inference_model.greedy_head

    def head(probs):
        store.append(probs.topk(2, dim=-1).values.cpu().numpy())
        return orig(probs)

    batch_stream.greedy_head = inference_model.greedy_head = head
    try:
        yield store
    finally:
        batch_stream.greedy_head = inference_model.greedy_head = orig


def stream(pred, wav, piece=None):
    """predict_stream over `wav` (whole, or in pieces of `piece` samples)
    → {text, ids, maxp, top2 (per decoded frame), windows}."""
    piece = piece or len(wav)
    top2, text = [], None
    with record_top2(top2):
        for i in range(0, len(wav), piece):
            r = pred.predict_stream(wav[i:i + piece],
                                    is_end=i + piece >= len(wav))
            text = r["text"] if r is not None else text
    dec = pred.greedy_chunk_decoder
    ids = np.asarray(dec._max_index)
    out = {"text": text, "ids": ids, "maxp": np.asarray(dec._max_prob),
           "top2": np.concatenate([t[0] for t in top2])[:len(ids)],
           "windows": len(top2)}
    pred.reset_stream()
    return out


def same_text(got, ref, what):
    """Texts equal, or they part at a frame whose top-2 margin in `ref`
    is <= ARGMAX_MARGIN (printed). → the margin, or None if equal."""
    if got["text"] == ref["text"]:
        return None
    n = min(len(got["ids"]), len(ref["ids"]))
    diff = np.flatnonzero(got["ids"][:n] != ref["ids"][:n])
    check(len(diff) > 0, f"{what}: texts differ with equal frame ids")
    f = int(diff[0])
    margin = float(ref["top2"][f, 0] - ref["top2"][f, 1])
    print(f"{what}: texts part at frame {f}, top-2 margin {margin}",
          file=sys.stderr, flush=True)
    check(margin <= ARGMAX_MARGIN, f"{what}: text differs at frame {f} with "
          f"top-2 margin {margin} > {ARGMAX_MARGIN}")
    return margin


def write_stream_bundle(flagship):
    """The flagship bundle's weights with dB normalization off (see the
    stream phase)."""
    path = os.path.join(WORK, "stream_bundle")
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(flagship, "inference.json"),
              encoding="utf-8") as f:
        meta = json.load(f)
    meta["preprocess_conf"] = dict(PREPROCESS, use_dB_normalization=False)
    with open(os.path.join(path, "inference.json"), "w",
              encoding="utf-8") as f:
        json.dump(meta, f, ensure_ascii=False)
    for name in ("model.msgpack", "vocabulary.txt"):
        shutil.copyfile(os.path.join(flagship, name),
                        os.path.join(path, name))
    return path


def phase_stream(dev, path, wav):
    from masr_tpu_torch.infer.predictor import MASRPredictor
    n_layers = FLAGSHIP_ENCODER["num_blocks"]
    rows, launches = [], 0
    for fused in (True, False):
        gpu = MASRPredictor(model_dir=path, device=dev,
                            fused_frontend=fused)
        cpu = MASRPredictor(model_dir=path, device="cpu", warmup=False,
                            fused_frontend=fused)
        runs = {}
        for piece in (None, PIECE):
            # the main path: counts read around predict_stream alone
            reset_launches()
            got = stream(gpu, wav, piece)
            n = chunk_launches()
            check(n == n_layers * got["windows"],
                  f"chunk kernel launches {n} == {n_layers} layers x "
                  f"{got['windows']} windows (fused={fused}, piece={piece})")
            launches += n
            ref = stream(cpu, wav, piece)
            check(len(got["ids"]) == len(ref["ids"]) > 0,
                  "decoded frames card == CPU")
            err = float(np.abs(got["maxp"] - ref["maxp"]).max())
            check(err <= PROBS_ATOL, f"per-window max probs card vs CPU "
                  f"{err} <= {PROBS_ATOL}")
            sure = ref["top2"][:, 0] - ref["top2"][:, 1] > ARGMAX_MARGIN
            flips = int(((got["ids"] != ref["ids"]) & sure).sum())
            check(flips == 0, f"{flips} argmax flips where top-2 margin > "
                  f"{ARGMAX_MARGIN}")
            runs[piece] = got
            rows.append({"fused_frontend": fused,
                         "piece_s": piece and piece / 16000,
                         "windows": got["windows"], "launches": n,
                         "maxp_max_abs_err": err,
                         "frames_compared": int(sure.sum()),
                         "text_equal_cpu": got["text"] == ref["text"]})
        check(runs[None]["text"] == runs[PIECE]["text"],
              f"whole == 0.2 s pieces text (fused={fused})")
        check(bool(runs[None]["text"]), "predict_stream text not empty")
    emit({"phase": "stream", "seconds_audio": round(len(wav) / 16000, 3),
          "runs": rows})
    return launches


def phase_engine(dev, path, wavs):
    from masr_tpu_torch.infer.batch_stream import BatchStreamSession
    from masr_tpu_torch.infer.predictor import MASRPredictor
    n_layers = FLAGSHIP_ENCODER["num_blocks"]
    gpu = MASRPredictor(model_dir=path, device=dev, fused_frontend=False)
    refs = [stream(gpu, w) for w in wavs]

    def run(pred, streams, max_streams, **kw):
        """feed_many in 0.2 s pieces, stream k starting 3*(k % 8) + k // 8
        pieces late → (per-stream {text, ids, top2}, dispatch routes)."""
        sess = BatchStreamSession(
            pred.predictor, pred._vocab_list, max_streams=max_streams,
            preprocess_conf=pred.predictor.meta["preprocess_conf"], **kw)
        orig, routes = sess._dispatch, []
        top2 = {s: [] for s in range(max_streams)}

        def spy(xs, active, valids, exact):
            rec = []
            with record_top2(rec):
                out = orig(xs, active, valids, exact)
            for slot, n in valids.items():
                top2[slot].append(rec[0][slot, :n])
            routes.append((int(np.sum(active)), bool(exact)))
            return out

        sess._dispatch = spy
        slots = [sess.open() for _ in streams]
        late = [3 * (k % 8) + k // 8 for k in range(len(streams))]
        n_pieces = max(len(w) // PIECE + 1 + d for w, d in zip(streams, late))
        texts = [None] * len(streams)
        for i in range(n_pieces):
            items = [(slot, w[(i - d) * PIECE:(i - d + 1) * PIECE],
                      (i - d + 1) * PIECE >= len(w))
                     for slot, w, d in zip(slots, streams, late)
                     if 0 <= i - d and (i - d) * PIECE < len(w)]
            if items:
                for slot, r in sess.feed_many(items).items():
                    if r is not None:
                        texts[slots.index(slot)] = r["text"]
        out = [{"text": t, "ids": np.asarray(sess._decoders[s]._max_index),
                "top2": np.concatenate(top2[s])}
               for s, t in zip(slots, texts)]
        for slot in slots:
            sess.close(slot)
        return out, routes

    streams = [wavs[k % len(wavs)] for k in range(ENGINE_STREAMS)]
    # the main path: counts read around the engine run alone
    reset_launches()
    t0 = time.perf_counter()
    got, routes = run(gpu, streams, ENGINE_STREAMS)
    wall = time.perf_counter() - t0
    launches = chunk_launches()
    check(launches == n_layers * len(routes), f"chunk kernel launches "
          f"{launches} == {n_layers} layers x {len(routes)} dispatches")
    check(not any(exact for _, exact in routes), "all on the table route")
    margins = [same_text(g, refs[k % len(wavs)], f"engine stream {k}")
               for k, g in enumerate(got)]
    # the CPU engine on four slots
    cpu = MASRPredictor(model_dir=path, device="cpu", warmup=False,
                        fused_frontend=False)
    cpu_got, _ = run(cpu, wavs[:4], 4)
    cpu_margins = [same_text(got[k], cpu_got[k], f"engine card vs CPU {k}")
                   for k in range(4)]
    # a position table one window past the cache: slots cross its horizon
    # and switch to exact positions, alone or beside table slots
    tiny, tiny_routes = run(gpu, wavs, len(wavs),
                            pos_table_len=CACHE + CHUNK + 4 * CHUNK)
    check(any(e for _, e in tiny_routes) and not all(
        e for _, e in tiny_routes), "both position routes dispatched")
    tiny_margins = [same_text(tiny[k], got[k], f"horizon stream {k}")
                    for k in range(len(wavs))]
    emit({"phase": "engine", "streams": ENGINE_STREAMS,
          "dispatches": len(routes), "launches": launches,
          "mean_active": float(np.mean([n for n, _ in routes])),
          "texts_equal_predict_stream": sum(m is None for m in margins),
          "cpu_slots_equal": sum(m is None for m in cpu_margins),
          "horizon_dispatches": {"table": sum(not e for _, e in tiny_routes),
                                 "exact": sum(e for _, e in tiny_routes)},
          "horizon_texts_equal": sum(m is None for m in tiny_margins),
          "parted_margins": [m for m in margins + cpu_margins + tiny_margins
                             if m is not None],
          "wall_s": wall})
    return launches


def phase_bundle_stream(dev):
    from masr_tpu_torch.audio.synth_tts import SyntheticTTS
    from masr_tpu_torch.infer.predictor import MASRPredictor
    tts = SyntheticTTS(sample_rate=16000)
    gpu = MASRPredictor(model_dir=TINY_BUNDLE, device=dev)
    cpu = MASRPredictor(model_dir=TINY_BUNDLE, device="cpu", warmup=False)
    rows = []
    for text, spk in HELD_OUT:
        wav = tts.render(text, spk_id=spk)
        reset_launches()
        got = stream(gpu, wav, PIECE)
        check(chunk_launches() == 2 * got["windows"],
              "example bundle: 2 layers x windows chunk launches")
        rows.append((text, got["text"], stream(cpu, wav, PIECE)["text"]))
    exact = sum(want == got for want, got, _ in rows)
    check(exact >= 2, f"bundle streamed {exact}/3 held-out sentences")
    check(all(got == ref for _, got, ref in rows), "card text == CPU text")
    emit({"phase": "bundle_stream", "exact": exact, "of": len(rows),
          "texts": [got for _, got, _ in rows]})


def time_chunk(layer, args):
    """Kernel vs plain on the same inputs (max abs err of outputs), then
    CUDA-event times in the order plain, kernel, kernel, plain."""
    from masr_tpu_torch.ops.cuda import chunk_layer as ck

    def kernel():
        return run_chunk(ck.fused_chunk_layer, layer, args)

    def plain():
        return run_chunk(ck.fused_chunk_layer_plain, layer, args)

    with torch.no_grad():
        att, cnn = args[3].clone(), args[4].clone()
        y_k = kernel()
        args[3].copy_(att)
        args[4].copy_(cnn)
        err = (y_k - plain()).abs().max().item()
        check(err <= KERNEL_ATOL, f"chunk kernel vs plain max abs err {err} "
              f"<= {KERNEL_ATOL} (timed shape, B={args[0].shape[0]})")
        runs = {"plain": [cuda_ms(plain)], "kernel": [cuda_ms(kernel)]}
        runs["kernel"].append(cuda_ms(kernel))
        runs["plain"].append(cuda_ms(plain))
    return runs, err


def phase_stream_times(dev, path, wavs, smi):
    from masr_tpu_torch.infer.batch_stream import BatchStreamSession
    from masr_tpu_torch.infer.predictor import MASRPredictor
    # one flagship chunk-layer call at the engine's steady state: 32 slots,
    # full caches, table positions
    B = ENGINE_STREAMS
    layer = seeded_layer(13, True, dev)
    clens, active = [CACHE] * B, [1] * B
    args = chunk_inputs(layer, B, CHUNK, clens,
                        [(37 * s) % CACHE for s in range(B)],
                        [CACHE + 64 * s for s in range(B)], active, "table",
                        5, dev)
    runs, err = time_chunk(layer, args)
    bound = chunk_bound(layer, clens, active, CHUNK, CACHE)
    # and predict_stream's shape: one slot
    one_runs, one_err = time_chunk(layer, chunk_inputs(
        layer, 1, CHUNK, [CACHE], [5], [CACHE + 64], [1], "exact", 6, dev))
    one_bound = chunk_bound(layer, [CACHE], [1], CHUNK, CACHE)

    # engine tick wall: every slot gets 0.64 s (one window) per feed_many
    need = FIRST_WINDOW_SAMPLES + 12 * STRIDE_SAMPLES
    long_wavs = [np.tile(w, -(-need // len(w)))[:need] for w in wavs]
    gpu = MASRPredictor(model_dir=path, device=dev, fused_frontend=False)
    sess = BatchStreamSession(
        gpu.predictor, gpu._vocab_list, max_streams=B,
        preprocess_conf=gpu.predictor.meta["preprocess_conf"])
    slots = [sess.open() for _ in range(B)]
    orig, dispatched, dispatch_s, ticks = sess._dispatch, [], [], []

    def clocked(xs, act, valids, exact):
        dispatched.append(int(np.sum(act)))
        t0 = time.perf_counter()
        out = orig(xs, act, valids, exact)
        dispatch_s.append(time.perf_counter() - t0)
        return out

    sess._dispatch = clocked
    for t in range(13):
        lo = 0 if t == 0 else FIRST_WINDOW_SAMPLES + (t - 1) * STRIDE_SAMPLES
        hi = FIRST_WINDOW_SAMPLES + t * STRIDE_SAMPLES
        items = [(s, long_wavs[s % len(wavs)][lo:hi], False) for s in slots]
        t0 = time.perf_counter()
        sess.feed_many(items)
        ticks.append(time.perf_counter() - t0)
    check(dispatched == [B] * 13, f"one {B}-slot dispatch per feed_many "
          f"({dispatched})")
    tick = float(np.median(ticks[3:]))

    # predict_stream window latency at B = 1, fused frontend
    one = MASRPredictor(model_dir=path, device=dev)
    wav = long_wavs[7]
    lat = []
    one.predict_stream(wav[:FIRST_WINDOW_SAMPLES])
    for t in range(12):
        lo = FIRST_WINDOW_SAMPLES + t * STRIDE_SAMPLES
        t0 = time.perf_counter()
        r = one.predict_stream(wav[lo:lo + STRIDE_SAMPLES])
        lat.append(time.perf_counter() - t0)
        check(r is not None, "a result after every 0.64 s")
    one.reset_stream()
    emit({"phase": "stream_times", "card": smi,
          "chunk_layer": {"B": B, "c": CHUNK, "C": CACHE, "D": 256,
                          "ffn": 2048, "max_abs_err": err,
                          "kernel_ms": runs["kernel"],
                          "plain_ms": runs["plain"], **bound},
          "chunk_layer_B1": {"max_abs_err": one_err,
                             "kernel_ms": one_runs["kernel"],
                             "plain_ms": one_runs["plain"], **one_bound},
          "engine": {"slots": B, "tick_s": ticks, "tick_s_median": tick,
                     "dispatch_s": dispatch_s,
                     "dispatch_s_median": float(np.median(dispatch_s[3:])),
                     "x_real_time": B * 0.64 / tick},
          "predict_stream": {"window_s": lat,
                             "p50_s": float(np.percentile(lat, 50)),
                             "p90_s": float(np.percentile(lat, 90))}})
    return (float(np.mean(runs["kernel"])), float(np.mean(runs["plain"])),
            max(err, one_err), bound)


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from masr_tpu_torch.ops.cuda import build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = card()

    t0 = time.perf_counter()
    built = build.build(["conformer_layer", "chunk_layer"])
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_seconds": built, "card": smi})

    worst = phase_kernels(dev)
    gpu, wavs, launches = phase_flagship(dev)
    phase_bundle(dev)
    ms, plain_ms, err, bound = phase_times(dev, gpu, wavs, smi)

    chunk_worst = phase_chunk_kernels(dev)
    path = write_stream_bundle(gpu.model_dir)
    phase_stream(dev, path, wavs[3])
    chunk_launches_main = phase_engine(dev, path, wavs)
    phase_bundle_stream(dev)
    c_ms, c_plain_ms, c_err, c_bound = phase_stream_times(dev, path, wavs,
                                                          smi)

    emit({"kernels": [{
        "name": "fused_conformer_layer", "route": "cuda",
        "source": "masr_tpu_torch/csrc/conformer_layer.cu",
        "replaces": "masr_tpu/ops/pallas/conformer_layer.py:188",
        "launches": launches, "max_abs_err": max(worst, err), "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound["bound_ms"],
        "bound_by": bound["bound_by"], "library_ms": None}, {
        "name": "fused_chunk_layer", "route": "cuda",
        "source": "masr_tpu_torch/csrc/chunk_layer.cu",
        "replaces": "masr_tpu/ops/pallas/chunk_layer.py:412",
        "launches": chunk_launches_main,
        "max_abs_err": max(chunk_worst, c_err), "ms": c_ms,
        "plain_ms": c_plain_ms, "bound_ms": c_bound["bound_ms"],
        "bound_by": c_bound["bound_by"], "library_ms": None}]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
