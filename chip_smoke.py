#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (masr_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's offline and streaming recognition and its training (the
Conformer and the Squeezeformer), and the offline recognition of
static-chunk models, through their public entry points
(MASRPredictor.predict_batch, MASRPredictor.predict_stream,
BatchStreamSession, MASRTrainer.train) and holds every hand-written kernel
of those paths against its plain PyTorch twin. Phases, one JSON line each:

  1. build          compile the eight CUDA sources of the repo (nvcc, sm_90a),
                    one process per source, all started together
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
                    and B=1 (predict_stream's shape); at B=32 each slot's
                    B=1 call must give the bits of its slice (output and
                    caches)
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
 11. train_kernels  the training-layer kernel vs its plain twin at flagship
                    width, B=8, T'=299, a dynamic-chunk mask with padding:
                    output and every grad, at dropout 0 and 0.1 / 0.1 (same
                    hash); the CTC kernel vs its plain twin (and both
                    against the plain twin in f64) at B=8, T'=299, V=4000,
                    labels of 5..40 and 80 (S = 161 states)
 12. train          MASRTrainer(dict config, device=cuda).train on synthetic
                    speech (build/smoke/train): flagship widths, vocabulary
                    4000, B=8, 2 epochs of 16 steps, then a second trainer
                    resumes from last_model for a third; every step must
                    launch the training-layer kernel 12x forward and 12x
                    backward and the CTC kernel once each way; the loss per
                    label token and the test loss fall; the first step at
                    dropout 0 against the CPU (loss and a sample of grads)
 13. train_times    training layer forward and backward and CTC forward +
                    backward, kernel vs plain (and F.ctc_loss for CTC), CUDA
                    events; train-step wall times, audio seconds trained
                    per second, and a torch.profiler breakdown of three
                    steps on the longest batch
 14. sq_kernels     the full-context Squeezeformer layer kernel vs its plain
                    twin at the width of configs/squeezeformer.yml (D=256,
                    4 heads, FFN 2048, conv 31): B=4 ragged, T' in {37, 150,
                    299, 1500}, BatchNorm and layer_norm conv norms; the
                    Squeezeformer chunk kernel vs its plain twin at B=32 and
                    B=1, full rate (c=16, C=256) and half rate (c=8, C=128
                    on the full-resolution ring), n_sub=2, four inactive
                    slots (caches bitwise unchanged), wrapping write
                    pointers; at B=32 each slot's B=1 bits == its slice
 15. sq_flagship    the 12-block Squeezeformer of configs/squeezeformer.yml
                    (reduce 5, recover 11, BatchNorm statistics in the
                    bundle's batch_stats), weights from a seed: predict_batch
                    of the 8 utterances, card vs CPU, 12 layer-kernel
                    launches per encode
 16. sq_stream      its predict_stream, both frontends, whole and in 0.2 s
                    pieces, card vs CPU; 12 chunk launches per window
 17. sq_engine      a 32-stream BatchStreamSession: texts == predict_stream's,
                    12 chunk launches per dispatch, 4 slots on the CPU
 18. sq_times       both Squeezeformer kernels vs their plain twins (CUDA
                    events): the layer at B=8, T'=299 (full rate) and 150
                    (half rate); the chunk layer at B=32 and B=1, both
                    rates; predict_batch wall, engine tick at 32 streams
 19. sq_train_kernels  the Squeezeformer training-layer kernel vs its plain
                    twin at the width of configs/squeezeformer.yml with the
                    layer_norm conv, B=8, full rate (T'=299) and half rate
                    (T'=150: the mask's [::2, ::2], lengths halved rounding
                    up), dynamic-chunk mask with padding, dropout 0 and
                    0.1 / 0.1: output and every grad
 20. sq_train       MASRTrainer(dict config, device=cuda).train of that
                    Squeezeformer (configs/squeezeformer.yml, cnn_norm_type
                    layer_norm, AdamW + NoamHoldAnnealing) on phase 12's
                    corpus (build/smoke/sq_train): 2 epochs of 16 steps at
                    B=8 and a resumed third, every step 12 + 12 launches of
                    the training-layer kernel and 1 + 1 of the CTC kernel,
                    the loss per label token and the test loss falling, the
                    first step at dropout 0 against the CPU; then one epoch
                    of the BatchNorm default (eager layers, no training-
                    layer launch, running statistics moved; first step and
                    statistics against the CPU; its validation pass runs
                    the eager attention through the flash kernel, whose
                    launches are recorded, and no train step launches it)
 21. sq_train_times the Squeezeformer training layer forward and backward,
                    kernel vs plain, at both rates (CUDA events), bounds;
                    train-step wall times, audio seconds trained per second,
                    a torch.profiler breakdown of three steps
 22. flash_kernels  the masked rel-pos flash attention kernel vs its plain
                    twin at flagship width (4 heads, d_k 64), B=4 ragged (one
                    utterance of 0 frames), T' in {37, 299, 800, 1500, 3000},
                    q, k, v as the module passes them (views of (B, T', D)
                    rows), masks: full context (the broadcast expand view),
                    static chunk 16 with every left chunk and with 4, the
                    half-rate [::2, ::2], random with empty rows and tiles;
                    d_k 32 and 128 at T'=299; output finite, rows with no
                    visible key exactly 0, the kernel's tile map (its
                    pre-pass: hidden / full / partial 64 x 64 tiles) equal
                    to the plain map
 23. static_flagship  each flagship (configs/conformer.yml and
                    configs/squeezeformer.yml widths, vocabulary 4000,
                    seeded weights) with encoder_conf use_dynamic_chunk
                    false and static_chunk_size 16 (the Conformer streaming,
                    the Squeezeformer offline: masr_tpu gives that family a
                    dynamic chunk whenever it streams): the predictor's
                    warmup (predict), predict_batch of the 8 utterances and
                    of 4 long ones (32-60 s, T' ~800-1500), predict of
                    one; every encode launches the flash kernel 12 times and
                    no full-context layer kernel; probs card vs CPU
 24. flash_times    the flash kernel vs its twin and F.scaled_dot_product_
                    attention (the library call, timed only, and the
                    backend it takes by the dispatcher's rule) at B=8 under
                    the static-16 mask with lengths T' down to 0.53 T', T'
                    in {150, 299, 800, 1500, 3000} (CUDA events, and the
                    device time of kernel and SDPA from torch.profiler),
                    with the bound over the visible pairs (f32 and 3xTF32)
                    and the dense one; the long batch's predict_batch wall
                    for both families

A text that differs between two runs fails only where the first differing
frame's top-2 margin exceeds 1e-3 (a near-tie that f32 sums in another
order may flip). Then the script's total seconds, the kernels line, the
card's name and power limit, and last {"ok": true, "device": {...}}. Any failed check raises: the script
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
# configs/squeezeformer.yml encoder_conf and decoder_conf (cnn_norm_type:
# the BatchNorm default; streaming: True → causal conv, `stream` reduction)
SQ_ENCODER = dict(encoder_dim=256, output_size=256, attention_heads=4,
                  num_blocks=12, reduce_idx=5, recover_idx=11,
                  feed_forward_expansion_factor=8, input_dropout_rate=0.1,
                  feed_forward_dropout_rate=0.1, attention_dropout_rate=0.1,
                  adaptive_scale=True, cnn_module_kernel=31,
                  normalize_before=False, activation_type="swish",
                  pos_enc_layer_type="rel_pos")
SQ_DECODER = dict(attention_heads=4, linear_units=1024, num_blocks=3,
                  r_num_blocks=3, dropout_rate=0.1,
                  positional_dropout_rate=0.1,
                  self_attention_dropout_rate=0.1,
                  src_attention_dropout_rate=0.1)
PREPROCESS = dict(feature_method="fbank", n_mels=80, n_mfcc=40,
                  sample_rate=16000, use_dB_normalization=True, target_dB=-20)
VOCAB = 4000                                          # bench.py:61
# the bundle's first three held-out sentences (tools/head_to_head.py
# make_corpus(240, 24)) and their speakers, as tests/test_example_bundle.py
HELD_OUT = [("上家音月火少", 0), ("风大你火下雪", 1), ("蓝右黑真", 0)]

KERNEL_ATOL = 2e-4        # f32 FMA or 3xTF32 vs f32 PyTorch, other sum order
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
# cores, TF32 on them, HBM3 bandwidth. A 3xTF32 product (every layer and
# attention kernel: f32 accuracy from three TF32 products) peaks at a third
# of TF32's rate.
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
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
    # the main path's pack: the serving tensor-core pack with the rest
    return fn(x, lens, pos_p, layer.chunk_packed_params(),
              n_head=layer.attention_heads, ksize=layer.cnn_module_kernel,
              causal=layer.causal)


def utterance_bits_match(run, layer, x, lens, pos_p, got, what):
    """Each utterance's B=1 call of a full-context layer kernel gives the
    bits of its slice of the batched call `got` (its products' split of K
    depends on K alone, its attention on the utterance alone). → number of
    utterances checked."""
    with torch.no_grad():
        for b in range(x.shape[0]):
            one = run(layer, x[b:b + 1], lens[b:b + 1], pos_p)
            check(torch.equal(one[0], got[b]), f"utterance {b} alone gives "
                  f"the bits of its slice of the batch ({what})")
    return x.shape[0]


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
            what = f"T'={T}, causal={causal}"
            check(bool(torch.isfinite(got).all()),
                  f"kernel output finite ({what})")
            err = max((got[b, :n] - want[b, :n]).abs().max().item()
                      for b, n in enumerate(lens) if n)
            check(err <= KERNEL_ATOL, f"kernel vs plain max abs err {err} "
                  f"<= {KERNEL_ATOL} ({what})")
            bits = utterance_bits_match(
                lambda m, *a: run_layer(cl.fused_conformer_layer, m, *a),
                layer, x, lens_t, pos_p, got, what)
            cases.append({"T": T, "lens": lens, "causal": causal,
                          "max_abs_err": err, "b1_bits_equal": bits})
            worst = max(worst, err)
    emit({"phase": "kernels", "kernel": "fused_conformer_layer", "B": 4,
          "D": 256, "heads": 4, "ffn": 2048, "conv_kernel": 15,
          "atol": KERNEL_ATOL, "cases": cases})
    return worst


def write_flagship_bundle(path, use_model="conformer", static_chunk=0):
    """A flagship bundle (the Conformer's, or with use_model="squeezeformer"
    the Squeezeformer's of configs/squeezeformer.yml, BatchNorm statistics
    in batch_stats) with weights drawn from seed 0, written the way
    masr_tpu's exporter writes one (flax msgpack), CMVN from the example
    bundle (same fbank frontend). With static_chunk, a static-chunk model:
    encoder_conf use_dynamic_chunk false and that static_chunk_size; the
    Squeezeformer then has streaming off (with it on, masr_tpu's and the
    port's SqueezeformerModel force a dynamic chunk)."""
    from masr_tpu_torch.infer import flax_msgpack
    from masr_tpu_torch.models.registry import build_model
    from masr_tpu_torch.models.weights import (seeded_state_dict,
                                               to_flax_variables)
    with open(os.path.join(TINY_BUNDLE, "inference.json"),
              encoding="utf-8") as f:
        tiny = json.load(f)
    encoder_conf, decoder_conf = (FLAGSHIP_ENCODER, {}) \
        if use_model == "conformer" else (SQ_ENCODER, SQ_DECODER)
    streaming = True
    if static_chunk:
        encoder_conf = dict(encoder_conf, static_chunk_size=static_chunk)
        if use_model == "conformer":
            encoder_conf["use_dynamic_chunk"] = False
        else:
            streaming = False
    model = build_model(use_model, 80, VOCAB, streaming=streaming,
                        encoder_conf=encoder_conf, decoder_conf=decoder_conf)
    state = seeded_state_dict(model, seed=0)
    # CTC head ×8: the frame posteriors peak as a trained model's do; at
    # the default init they sit near 1/V, and no frame would have a top-2
    # margin for the argmax comparison
    state["ctc.ctc_lo.weight"] *= 8.0
    variables = to_flax_variables(state)
    meta = {"framework": "masr_tpu", "use_model": use_model,
            "streaming": streaming, "input_dim": 80, "vocab_size": VOCAB,
            "mean": tiny["mean"], "istd": tiny["istd"],
            "encoder_conf": encoder_conf, "decoder_conf": decoder_conf,
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


def layer_kernel(family):
    """The full-context layer kernel's wrapper (its .launches counts)."""
    if family == "conformer":
        from masr_tpu_torch.ops.cuda.conformer_layer import \
            fused_conformer_layer as fn
    else:
        from masr_tpu_torch.ops.cuda.squeezeformer_layer import \
            fused_squeezeformer_layer as fn
    return fn


def flash_kernel():
    """The masked rel-pos flash attention's wrapper (its .launches counts)."""
    from masr_tpu_torch.ops.cuda.rel_pos_attention import \
        rel_pos_flash_attention as fn
    return fn


def chunk_kernel(family):
    """The chunk-layer kernel's wrapper (its .launches counts)."""
    if family == "conformer":
        from masr_tpu_torch.ops.cuda.chunk_layer import \
            fused_chunk_layer as fn
    else:
        from masr_tpu_torch.ops.cuda.chunk_layer_sq import \
            fused_chunk_layer_sq as fn
    return fn


def phase_flagship(dev, family="conformer"):
    """predict_batch of the 8 utterances on the family's flagship: card vs
    CPU probs, launches per encode (phase "flagship" / "sq_flagship")."""
    from masr_tpu_torch.infer.predictor import MASRPredictor
    path = os.path.join(WORK, f"{family}_bundle")
    wavs = synthetic_utterances(write_flagship_bundle(path, family))
    gpu = MASRPredictor(model_dir=path, device=dev)
    # the main path: counts read around predict_batch alone
    reset_launches()
    t0 = time.perf_counter()
    texts = gpu.predict_batch(wavs)
    wall = time.perf_counter() - t0
    launches = layer_kernel(family).launches
    n_layers = FLAGSHIP_ENCODER["num_blocks"]
    check(launches == n_layers, f"{family} kernel launches {launches} == "
          f"{n_layers} layers x 1 encoder call")
    check(flash_kernel().launches == 0, "no flash attention launch without "
          "a static chunk")
    cpu = MASRPredictor(model_dir=path, device="cpu", warmup=False)
    err, compared, t_out = probs_card_vs_cpu(gpu, cpu, wavs)
    cpu_texts = cpu.predict_batch(wavs)
    emit({"phase": "flagship" if family == "conformer" else "sq_flagship",
          "utterances": len(wavs),
          "seconds_audio": [round(len(w) / 16000, 3) for w in wavs],
          "T_out": t_out, "launches": launches,
          "probs_max_abs_err": err, "probs_atol": PROBS_ATOL,
          "argmax_frames_compared": compared,
          "texts_equal_cpu": sum(a["text"] == b["text"]
                                 for a, b in zip(texts, cpu_texts)),
          "predict_batch_s": wall})
    return gpu, wavs, launches


def probs_card_vs_cpu(gpu, cpu, wavs):
    """The batch's CTC probs on the card vs the CPU (the twins): shapes and
    lengths equal, finite, within PROBS_ATOL over the valid frames, no
    argmax flip where the CPU's top-2 margin exceeds ARGMAX_MARGIN. → (max
    abs err, frames compared, T')."""
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
    return err, compared, int(p_gpu.shape[1])


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


def device_ms(fn, n=10):
    """Device time per call of fn (ms): the CUDA kernels it launches, their
    own time summed over n calls (torch.profiler), without the host's gaps
    between launches that CUDA events over back-to-back calls include."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    us = 0.0
    for ev in prof.key_averages():
        t = getattr(ev, "self_device_time_total", None)
        us += getattr(ev, "self_cuda_time_total", 0.0) if t is None else t
    return us / 1e3 / n if us > 0 else "not measured"


def alternate(kernel, plain):
    """CUDA-event times in the order plain, kernel, kernel, plain."""
    runs = {"plain": [cuda_ms(plain)], "kernel": [cuda_ms(kernel)]}
    runs["kernel"].append(cuda_ms(kernel))
    runs["plain"].append(cuda_ms(plain))
    return runs


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
        runs = alternate(kernel, plain)
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


def _bound_3xtf32(flops, nbytes):
    """The same work on the tensor cores in 3xTF32 (three TF32 products
    per product): the bound beside the f32 one for every kernel but CTC
    (rows 1, 2, 3, 5, 6, 7 and 8)."""
    return {"bound_3xtf32_ms": max(3 * flops / PEAK_TF32_FLOPS,
                                   nbytes / PEAK_BYTES_S) * 1e3}


def _weight_bytes(layer):
    return 4 * sum(t.numel() for t in layer.packed_params().values())


def _widths(layer):
    """(d_model, FFN units, conv kernel) of a Conformer or Squeezeformer
    layer."""
    return (layer.size, layer.packed_params()["ffw1"].shape[2],
            layer.cnn_module_kernel)


def layer_bound(layer, lens, T):
    """Full-context layer (Conformer or Squeezeformer: the same products)
    over valid rows: matmuls, rel-pos attention over the valid keys,
    depthwise conv (f32); bytes: packed weights, x in, out, pos_p, each
    once."""
    D, F, K = _widths(layer)
    M = sum(lens)
    flops = (8 * M * D * F + 8 * M * D * D        # FFN x2, q/k/v/out
             + 6 * M * D * D                      # pw1 (D -> 2D), pw2
             + 2 * M * D * K                      # depthwise
             + sum(6 * D * n * n for n in lens))  # [q+u|q+v].[k|p], AV
    nbytes = _weight_bytes(layer) + 4 * (2 * len(lens) * T * D + T * D)
    return {**_bound(flops, nbytes), **_bound_3xtf32(flops, nbytes)}


def chunk_bound(layer, clens, active, c, C, rep=1):
    """One chunk-layer call (n_sub = 1) over B slots at the layer's rate:
    matmuls over B*c rows (pw1 over the k-1+c conv-input rows), attention
    of each slot over its cache_len valid cache keys and the c chunk keys;
    bytes: packed weights, x in and out, the valid cache rows read, the
    fresh rows (rep copies each) and cnn caches of active slots written,
    each slot's position window, cnn caches read."""
    D, F, K = _widths(layer)
    B = len(clens)
    M, W = B * c, K - 1 + c
    flops = (8 * M * D * F + 8 * M * D * D + 4 * B * W * D * D
             + 2 * M * D * D + 2 * M * D * K
             + sum(6 * D * c * (n + c) for n in clens))
    n_act = sum(bool(a) for a in active)
    nbytes = _weight_bytes(layer) + 4 * (
        2 * M * D                                 # x in, out
        + sum(clens) * 2 * D                      # valid [K|V] cache rows
        + n_act * min(c, C) * 2 * D * rep         # fresh rows written
        + B * (C + c) * D                         # position windows
        + (B + n_act) * (K - 1) * D)              # cnn caches in, out
    return {**_bound(flops, nbytes), **_bound_3xtf32(flops, nbytes)}


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
            layer.chunk_packed_params())


def run_chunk(fn, layer, args, n_sub=1):
    x, pos, starts, att, cnn, clens, wptrs, active, packed = args
    return fn(x, pos, starts, att, cnn, clens, wptrs, active, packed,
              n_head=layer.attention_heads, ksize=layer.cnn_module_kernel,
              n_sub=n_sub)


def slot_bits_match(run, args, L=None):
    """Each slot's output and updated caches from a B=1 call (run(args))
    equal bit for bit its slice of one call over all the slots; with L
    (exact positions, L rows per slot) a slot reads its own window of pos
    from row 0, else the shared table at its start. → slots checked."""
    x, pos, starts, att, cnn, clens, wptrs, active, packed = args
    att0, cnn0 = att.clone(), cnn.clone()
    with torch.no_grad():
        y = run(args)
        for s in range(x.shape[0]):
            one = slice(s, s + 1)
            p1, s1 = ((pos[s * L:(s + 1) * L], torch.zeros_like(starts[one]))
                      if L is not None else (pos, starts[one]))
            a1 = (x[one], p1, s1, att0[one].clone(), cnn0[one].clone(),
                  clens[one], wptrs[one], active[one], packed)
            y1 = run(a1)
            check(torch.equal(y1, y[one]) and torch.equal(a1[3], att[one])
                  and torch.equal(a1[4], cnn[one]),
                  f"slot {s}: B=1 bits == its slice of the B={x.shape[0]} "
                  "call (output, att and cnn caches)")
    return x.shape[0]


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
        invariant = 0
        if B > 1:
            invariant = slot_bits_match(
                lambda a: run_chunk(ck.fused_chunk_layer, layer, a, n_sub),
                args, CACHE + c if route == "exact" else None)
        cases.append({"B": B, "c": c, "n_sub": n_sub, "route": route,
                      "inactive": int(off.sum()), "max_abs_err": err,
                      "b1_bits_equal_slots": invariant})
        worst = max(worst, err)
    emit({"phase": "chunk_kernels", "kernel": "fused_chunk_layer",
          "C": CACHE, "D": 256, "heads": 4, "ffn": 2048, "conv_kernel": 15,
          "cache_lens": [0, 5, 100, CACHE], "atol": KERNEL_ATOL,
          "cases": cases})
    return worst


def reset_launches():
    for family in ("conformer", "squeezeformer"):
        layer_kernel(family).launches = chunk_kernel(family).launches = 0
    flash_kernel().launches = 0


def chunk_launches(family="conformer"):
    return chunk_kernel(family).launches


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
    path = flagship + "_stream"
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


def phase_stream(dev, path, wav, family="conformer"):
    """predict_stream on the card vs the CPU, both frontends, whole and in
    0.2 s pieces (phase "stream" / "sq_stream")."""
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
            n = chunk_launches(family)
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
    emit({"phase": "stream" if family == "conformer" else "sq_stream",
          "seconds_audio": round(len(wav) / 16000, 3), "runs": rows})
    return launches


def phase_engine(dev, path, wavs, family="conformer"):
    """A 32-stream BatchStreamSession on the card vs predict_stream and a
    4-slot CPU engine; for an encoder with position tables, a tiny table
    whose horizon the streams cross (phase "engine" / "sq_engine")."""
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
    launches = chunk_launches(family)
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
    tiny_routes, tiny_margins = [], []
    if gpu.predictor.model.encoder.position_tables:
        tiny, tiny_routes = run(gpu, wavs, len(wavs),
                                pos_table_len=CACHE + CHUNK + 4 * CHUNK)
        check(any(e for _, e in tiny_routes) and not all(
            e for _, e in tiny_routes), "both position routes dispatched")
        tiny_margins = [same_text(tiny[k], got[k], f"horizon stream {k}")
                        for k in range(len(wavs))]
    emit({"phase": "engine" if family == "conformer" else "sq_engine",
          "streams": ENGINE_STREAMS,
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
        runs = alternate(kernel, plain)
    return runs, err


def engine_tick(dev, path, wavs, B):
    """Engine tick wall at B active slots, each given one window (0.64 s)
    per feed_many, 13 ticks: tick and dispatch times, median of ticks 4-13,
    and the real-time factor B x 0.64 s / tick."""
    from masr_tpu_torch.infer.batch_stream import BatchStreamSession
    from masr_tpu_torch.infer.predictor import MASRPredictor
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
    return {"slots": B, "tick_s": ticks, "tick_s_median": tick,
            "dispatch_s": dispatch_s,
            "dispatch_s_median": float(np.median(dispatch_s[3:])),
            "x_real_time": B * 0.64 / tick}


def window_latency(dev, path, wavs):
    """predict_stream window latency at B = 1, fused frontend, 12 windows
    of 0.64 s after the first."""
    from masr_tpu_torch.infer.predictor import MASRPredictor
    need = FIRST_WINDOW_SAMPLES + 12 * STRIDE_SAMPLES
    wav = np.tile(wavs[7], -(-need // len(wavs[7])))[:need]
    one = MASRPredictor(model_dir=path, device=dev)
    lat = []
    one.predict_stream(wav[:FIRST_WINDOW_SAMPLES])
    for t in range(12):
        lo = FIRST_WINDOW_SAMPLES + t * STRIDE_SAMPLES
        t0 = time.perf_counter()
        r = one.predict_stream(wav[lo:lo + STRIDE_SAMPLES])
        lat.append(time.perf_counter() - t0)
        check(r is not None, "a result after every 0.64 s")
    one.reset_stream()
    return {"window_s": lat, "p50_s": float(np.percentile(lat, 50)),
            "p90_s": float(np.percentile(lat, 90))}


def phase_stream_times(dev, path, wavs, smi):
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

    engine = engine_tick(dev, path, wavs, B)
    window = window_latency(dev, path, wavs)
    emit({"phase": "stream_times", "card": smi,
          "chunk_layer": {"B": B, "c": CHUNK, "C": CACHE, "D": 256,
                          "ffn": 2048, "max_abs_err": err,
                          "kernel_ms": runs["kernel"],
                          "plain_ms": runs["plain"], **bound},
          "chunk_layer_B1": {"max_abs_err": one_err,
                             "kernel_ms": one_runs["kernel"],
                             "plain_ms": one_runs["plain"], **one_bound},
          "engine": engine, "predict_stream": window})
    return (float(np.mean(runs["kernel"])), float(np.mean(runs["plain"])),
            max(err, one_err), bound)


# --------------------------------------------------------------------------- #
# Squeezeformer: the full-context and the chunk Squeezeformer layer kernels
# --------------------------------------------------------------------------- #
def seeded_sq_layer(seed, causal, conv_norm, device):
    """A layer of SQ_ENCODER's widths (D=256, 4 heads, FFN 2048, conv 31),
    weights and BatchNorm statistics drawn from `seed`."""
    from masr_tpu_torch.models.squeezeformer import SqueezeformerEncoderLayer
    from masr_tpu_torch.models.weights import seeded_state_dict
    e = SQ_ENCODER
    layer = SqueezeformerEncoderLayer(
        e["encoder_dim"], e["attention_heads"],
        e["encoder_dim"] * e["feed_forward_expansion_factor"],
        e["cnn_module_kernel"], conv_norm, causal)
    layer.load_state_dict(seeded_state_dict(layer, seed))
    return layer.to(device).eval()


def run_sq_layer(fn, layer, x, lens, pos_p):
    return fn(x, lens, pos_p, layer.chunk_packed_params(),
              n_head=layer.attention_heads, ksize=layer.cnn_module_kernel,
              causal=layer.causal, conv_ln=layer.conv_ln)


def sq_chunk_inputs(layer, B, c, C, rep, clens, wptrs, offsets, active, seed,
                    dev):
    """Arguments of fused_chunk_layer_sq for one flagship layer at its rate
    (c, C): a random chunk, a full-resolution ring (B, h, C·rep, 2·d_k) and
    cnn caches from `seed`, exact positions (one window of C + c rows per
    slot, as the encoder makes them)."""
    from masr_tpu_torch.models.embedding import sinusoid_position_encoding
    D, H = layer.size, layer.attention_heads
    K1, L = layer.cnn_module_kernel - 1, C + c
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(B, c, D, generator=g).to(dev)
    att = (0.5 * torch.randn(B, H, C * rep, 2 * D // H, generator=g)).to(dev)
    cnn = (0.5 * torch.randn(B, K1, D, generator=g)).to(dev)

    def i32(v):
        return torch.tensor(v, dtype=torch.int32, device=dev)

    with torch.no_grad():
        rows = torch.clamp(i32(offsets)[:, None].long() - C
                           + torch.arange(L, device=dev), min=0)
        pos = layer.self_attn.linear_pos(
            sinusoid_position_encoding(rows.reshape(-1), D))
    starts = torch.arange(B, dtype=torch.int32, device=dev) * L
    return (x, pos, starts, att, cnn, i32(clens), i32(wptrs), i32(active),
            layer.chunk_packed_params())


def run_sq_chunk(fn, layer, args, n_sub=1, rep=1):
    x, pos, starts, att, cnn, clens, wptrs, active, packed = args
    return fn(x, pos, starts, att, cnn, clens, wptrs, active, packed,
              n_head=layer.attention_heads, ksize=layer.cnn_module_kernel,
              conv_ln=layer.conv_ln, n_sub=n_sub, rep=rep)


def sq_chunk_case(B, rep, n_sub):
    """(c, C, cache_lens, wptrs, offsets, active) at the layer's rate:
    cache_len {0, 5, C/2, C} (B=1: C), write pointers that wrap, four
    inactive slots at B=32."""
    c, C = CHUNK * n_sub // rep, CACHE // rep
    clens = [C] if B == 1 else [(0, 5, C // 2, C)[s % 4] for s in range(B)]
    wptrs = [(C - 3 - 7 * s) % C for s in range(B)]
    offsets = [rep * n + 16 * s if n else 0 for s, n in enumerate(clens)]
    active = [0 if s in (3, 10, 17, 29) else 1 for s in range(B)]
    return c, C, clens, wptrs, offsets, active


def phase_sq_kernels(dev):
    """The full-context Squeezeformer layer kernel vs its plain twin at the
    flagship width, B=4 ragged, T' in {37, 150, 299, 1500}, BatchNorm and
    layer_norm conv norms (causal; non-causal too at T'=299), each
    utterance alone giving the bits of its slice of the batch; the chunk
    kernel vs its plain twin at B=32 and B=1, full rate (c=16, C=256) and
    half rate (c=8, C=128 on the full-resolution ring), n_sub 2 at B=32."""
    from masr_tpu_torch.ops.cuda import chunk_layer_sq as cks
    from masr_tpu_torch.ops.cuda import squeezeformer_layer as sq
    cases, worst = [], 0.0
    for T in (37, 150, 299, 1500):
        lens = [T, T - 17, 5, 0]
        for conv_norm, causal in ((("batch_norm", True),
                                   ("layer_norm", True))
                                  + ((("batch_norm", False),)
                                     if T == 299 else ())):
            layer = seeded_sq_layer(T + causal, causal, conv_norm, dev)
            x, lens_t, pos_p = layer_inputs(layer, lens, T, T + 2, dev)
            with torch.no_grad():
                got = run_sq_layer(sq.fused_squeezeformer_layer, layer, x,
                                   lens_t, pos_p)
                want = run_sq_layer(sq.fused_squeezeformer_layer_plain,
                                    layer, x, lens_t, pos_p)
            torch.cuda.synchronize()
            what = f"T'={T}, {conv_norm}, causal={causal}"
            check(bool(torch.isfinite(got).all()),
                  f"sq layer kernel output finite ({what})")
            err = max((got[b, :n] - want[b, :n]).abs().max().item()
                      for b, n in enumerate(lens) if n)
            check(err <= KERNEL_ATOL, f"sq layer kernel vs plain max abs err "
                  f"{err} <= {KERNEL_ATOL} ({what})")
            bits = utterance_bits_match(
                lambda m, *a: run_sq_layer(sq.fused_squeezeformer_layer, m,
                                           *a),
                layer, x, lens_t, pos_p, got, what)
            cases.append({"T": T, "lens": lens, "conv_norm": conv_norm,
                          "causal": causal, "max_abs_err": err,
                          "b1_bits_equal": bits})
            worst = max(worst, err)
    chunk_cases, chunk_worst = [], 0.0
    for B, rep, n_sub in ((32, 1, 1), (32, 2, 1), (32, 1, 2), (32, 2, 2),
                          (1, 1, 1), (1, 2, 1)):
        c, C, clens, wptrs, offsets, active = sq_chunk_case(B, rep, n_sub)
        layer = seeded_sq_layer(40 + B + rep, True, "batch_norm", dev)
        args = sq_chunk_inputs(layer, B, c, C, rep, clens, wptrs, offsets,
                               active, B + c, dev)
        att0, cnn0 = args[3], args[4]
        with torch.no_grad():
            got = {}
            for name, fn in (("kernel", cks.fused_chunk_layer_sq),
                             ("plain", cks.fused_chunk_layer_sq_plain)):
                a = args[:3] + (att0.clone(), cnn0.clone()) + args[5:]
                got[name] = (run_sq_chunk(fn, layer, a, n_sub, rep), a[3],
                             a[4])
        torch.cuda.synchronize()
        (y, att_k, cnn_k), (y_p, att_p, cnn_p) = got["kernel"], got["plain"]
        what = f"B={B}, c={c}, C={C}, rep={rep}, n_sub={n_sub}"
        check(bool(torch.isfinite(y).all()), f"sq chunk kernel output "
              f"finite ({what})")
        err = max((a - b).abs().max().item()
                  for a, b in ((y, y_p), (att_k, att_p), (cnn_k, cnn_p)))
        check(err <= KERNEL_ATOL, f"sq chunk kernel vs plain max abs err "
              f"{err} <= {KERNEL_ATOL} ({what})")
        off = torch.tensor(active, device=dev) == 0
        check(torch.equal(att_k[off], att0[off])
              and torch.equal(cnn_k[off], cnn0[off]),
              "inactive slots' att and cnn caches bitwise unchanged")
        invariant = 0
        if B > 1:
            invariant = slot_bits_match(
                lambda a: run_sq_chunk(cks.fused_chunk_layer_sq, layer, a,
                                       n_sub, rep), args, C + c)
        chunk_cases.append({"B": B, "c": c, "C": C, "rep": rep,
                            "n_sub": n_sub, "inactive": int(off.sum()),
                            "max_abs_err": err,
                            "b1_bits_equal_slots": invariant})
        chunk_worst = max(chunk_worst, err)
    emit({"phase": "sq_kernels", "atol": KERNEL_ATOL,
          "D": SQ_ENCODER["encoder_dim"], "heads": 4, "ffn": 2048,
          "conv_kernel": 31,
          "layer": {"kernel": "fused_squeezeformer_layer", "B": 4,
                    "cases": cases},
          "chunk": {"kernel": "fused_chunk_layer_sq", "cases": chunk_cases}})
    return worst, chunk_worst


def phase_sq_times(dev, gpu, wavs, stream_path, smi):
    """The Squeezeformer kernels vs their plain twins (CUDA events, plain,
    kernel, kernel, plain): the full-context layer at B=8 for a full-rate
    (T'=299) and a half-rate (T'=150) layer; the chunk layer at B=32 and
    B=1, full rate (c=16, C=256) and half rate (c=8, C=128), full caches;
    flagship predict_batch wall and the engine tick at 32 streams."""
    from masr_tpu_torch.ops.cuda import chunk_layer_sq as cks
    from masr_tpu_torch.ops.cuda import squeezeformer_layer as sq
    layers = {}
    for T in (299, 150):
        lens = [T] * 8
        layer = seeded_sq_layer(50 + T, True, "batch_norm", dev)
        x, lens_t, pos_p = layer_inputs(layer, lens, T, 9, dev)

        def kernel():
            return run_sq_layer(sq.fused_squeezeformer_layer, layer, x,
                                lens_t, pos_p)

        def plain():
            return run_sq_layer(sq.fused_squeezeformer_layer_plain, layer, x,
                                lens_t, pos_p)

        with torch.no_grad():
            err = (kernel() - plain()).abs().max().item()
            check(err <= KERNEL_ATOL, f"sq layer kernel vs plain max abs err "
                  f"{err} <= {KERNEL_ATOL} (timed shape, T'={T})")
            runs = alternate(kernel, plain)
        layers[T] = {"B": 8, "T": T, "max_abs_err": err,
                     "kernel_ms": runs["kernel"], "plain_ms": runs["plain"],
                     **layer_bound(layer, lens, T)}
    chunks = {}
    for B, rep in ((32, 1), (32, 2), (1, 1), (1, 2)):
        c, C = CHUNK // rep, CACHE // rep
        layer = seeded_sq_layer(60 + B + rep, True, "batch_norm", dev)
        clens, active = [C] * B, [1] * B
        args = sq_chunk_inputs(layer, B, c, C, rep, clens,
                               [(2 * s + 1) % C for s in range(B)],
                               [CACHE + 64 * s for s in range(B)], active,
                               7 + B, dev)

        def kernel():
            return run_sq_chunk(cks.fused_chunk_layer_sq, layer, args,
                                rep=rep)

        def plain():
            return run_sq_chunk(cks.fused_chunk_layer_sq_plain, layer, args,
                                rep=rep)

        with torch.no_grad():
            att, cnn = args[3].clone(), args[4].clone()
            y_k = kernel()
            args[3].copy_(att)
            args[4].copy_(cnn)
            err = (y_k - plain()).abs().max().item()
            check(err <= KERNEL_ATOL, f"sq chunk kernel vs plain max abs err "
                  f"{err} <= {KERNEL_ATOL} (timed shape, B={B}, rep={rep})")
            runs = alternate(kernel, plain)
        chunks[f"B{B}_{'full' if rep == 1 else 'half'}"] = {
            "B": B, "c": c, "C": C, "rep": rep, "max_abs_err": err,
            "kernel_ms": runs["kernel"], "plain_ms": runs["plain"],
            **chunk_bound(layer, clens, active, c, C, rep)}
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        gpu.predict_batch(wavs)
        walls.append(time.perf_counter() - t0)
    engine = engine_tick(dev, stream_path, wavs, ENGINE_STREAMS)
    emit({"phase": "sq_times", "card": smi,
          "layer": {"full_rate": layers[299], "half_rate": layers[150]},
          "chunk_layer": chunks, "predict_batch_s": walls,
          "predict_batch_audio_s": round(sum(len(w) for w in wavs) / 16000,
                                         3), "engine": engine})
    main_layer, main_chunk = layers[299], chunks["B32_full"]
    return ({"ms": float(np.mean(main_layer["kernel_ms"])),
             "plain_ms": float(np.mean(main_layer["plain_ms"])),
             "max_abs_err": max(v["max_abs_err"] for v in layers.values()),
             "bound_ms": main_layer["bound_ms"],
             "bound_by": main_layer["bound_by"]},
            {"ms": float(np.mean(main_chunk["kernel_ms"])),
             "plain_ms": float(np.mean(main_chunk["plain_ms"])),
             "max_abs_err": max(v["max_abs_err"] for v in chunks.values()),
             "bound_ms": main_chunk["bound_ms"],
             "bound_by": main_chunk["bound_by"]})


# --------------------------------------------------------------------------- #
# training: the training-layer and CTC kernels, MASRTrainer.train
# --------------------------------------------------------------------------- #
TRAIN_T, TRAIN_LENS = 299, [299, 281, 250, 220, 180, 150, 90, 33]
GRAD_RTOL = 1e-4        # grad max abs err over the plain grad's max |.|
CTC_GRAD_ATOL = 1e-4    # floor of the CTC grad check against f64
TRAIN_STEPS_PER_EPOCH, TRAIN_EPOCHS = 16, 2
CPU_LOSS_RTOL, CPU_GRAD_RTOL = 1e-4, 1e-3   # first step, card vs CPU


def train_layer_inputs(layer, seed, dev, half=False):
    """Flagship training-layer arguments at B=8, T'=299: random x and a
    dynamic-chunk (16-frame chunks, 4 left chunks) mask with padding; with
    `half`, the rows a Squeezeformer's time reduction leaves: the mask's
    [::2, ::2], the lengths halved rounding up, every second position
    (T'=150)."""
    from masr_tpu_torch.models.embedding import sinusoid_position_encoding
    g = torch.Generator().manual_seed(seed)
    T, B = TRAIN_T, len(TRAIN_LENS)
    lens = torch.tensor(TRAIN_LENS, dtype=torch.int32, device=dev)
    r = torch.arange(T, device=dev)
    rc, cc = r[:, None] // 16, r[None, :] // 16
    mask = ((cc <= rc) & (cc >= rc - 4))[None] & \
        (r[None, None, :] < lens[:, None, None])
    if half:
        mask, lens, r = mask[:, ::2, ::2], (lens + 1) // 2, r[::2]
    x = torch.randn(B, len(r), layer.size, generator=g).to(dev)
    w = torch.randn(B, len(r), layer.size, generator=g).to(dev)
    seeds = torch.randint(-2 ** 31, 2 ** 31 - 1, (B,), generator=g,
                          dtype=torch.int32).to(dev)
    with torch.no_grad():
        posp = layer.self_attn.linear_pos(sinusoid_position_encoding(
            r, layer.size))
        packed = {k: v.clone() for k, v in layer.packed_params().items()}
    return x, w, mask, seeds, lens, posp, packed


def run_train_layer(fn, layer, args, rates, grads=True):
    """→ (y, leaf tensors x, posp, packed) with y's graph built."""
    x, _, mask, seeds, lens, posp, packed = args
    xx = x.clone().requires_grad_(grads)
    pp = posp.clone().requires_grad_(grads)
    pk = {k: v.clone().requires_grad_(grads) for k, v in packed.items()}
    y = fn(xx, mask, seeds, lens, pp, pk, layer=5,
           n_head=layer.attention_heads, ksize=layer.cnn_module_kernel,
           causal=layer.causal, rate=rates[0], att_rate=rates[1])
    return y, xx, pp, pk


def rel_err(a, b):
    return (a - b).abs().max().item() / max(b.abs().max().item(), 1e-30)


def check_train_layer(fns, layer, args, rates):
    """The training-layer kernel fns[0] vs its plain twin fns[1] on the
    same inputs: output and every grad of sum(y * w) (x, posp, each packed
    array), checked against KERNEL_ATOL and GRAD_RTOL. → case dict."""
    res = []
    for fn in fns:
        y, xx, pp, pk = run_train_layer(fn, layer, args, rates)
        (y * args[1]).sum().backward()
        torch.cuda.synchronize()
        res.append((y.detach(), {"x": xx.grad, "posp": pp.grad,
                                 **{k: v.grad for k, v in pk.items()}}))
    (y_k, g_k), (y_p, g_p) = res
    T = tuple(y_k.shape)[1]
    check(bool(torch.isfinite(y_k).all()), "train layer output finite")
    err = (y_k - y_p).abs().max().item()
    check(err <= KERNEL_ATOL, f"train layer kernel vs plain max abs err "
          f"{err} <= {KERNEL_ATOL} (T'={T}, rates {rates})")
    gerr = {k: rel_err(g_k[k], g_p[k]) for k in g_p}
    for k, e in gerr.items():
        check(bool(torch.isfinite(g_k[k]).all()), f"grad {k} finite")
        check(e <= GRAD_RTOL, f"train layer grad {k}: {e} <= {GRAD_RTOL} "
              f"of its max (T'={T}, rates {rates})")
    return {"T": T, "rates": rates, "max_abs_err": err, "grad_rel_err": gerr}


def phase_train_kernels(dev):
    """Training-layer kernel vs plain (outputs and all grads) at dropout 0
    and 0.1 / 0.1, and the CTC kernel vs plain at B=8, T'=299, V=4000."""
    from masr_tpu_torch.ops.cuda import conformer_layer_train as clt
    from masr_tpu_torch.ops.cuda import ctc_loss as C
    layer = seeded_layer(21, True, dev)
    args = train_layer_inputs(layer, 22, dev)
    fns = (clt.fused_conformer_layer_train,
           clt.fused_conformer_layer_train_plain)
    cases = [check_train_layer(fns, layer, args, rates)
             for rates in ((0.0, 0.0), (0.1, 0.1))]
    worst = max(c["max_abs_err"] for c in cases)
    # CTC: label lengths 5..40 and one of 80 (S = 161 states)
    lg, lens, labels, label_lens = ctc_inputs(dev)
    wts = torch.randn(lg.shape[0], generator=torch.Generator().manual_seed(3)
                      ).to(dev)
    res = {}
    for name, fn, dtype in (("kernel", C.ctc_loss, torch.float32),
                            ("plain", C.ctc_loss_plain, torch.float32),
                            ("f64", C.ctc_loss_plain, torch.float64)):
        x = lg.detach().to(dtype).clone().requires_grad_(True)
        nll = fn(x, lens, labels, label_lens)
        (nll * wts.to(dtype)).sum().backward()
        torch.cuda.synchronize()
        res[name] = (nll.detach().double(), x.grad.double())
    (n_k, g_k), (n_p, g_p), (n_64, g_64) = (res["kernel"], res["plain"],
                                            res["f64"])
    check(bool(torch.isfinite(n_k).all() and torch.isfinite(g_k).all()),
          "CTC loss and grad finite")
    ctc_rel = ((n_k - n_p).abs() / n_p.abs()).max().item()
    ctc_gerr = (g_k - g_p).abs().max().item()
    # f32 log-space sums over T' frames with |log Z| ~ 3e3 leave ~1e-3 in
    # the occupancies: both f32 versions are held against the f64 twin
    k64, p64 = ((g_k - g_64).abs().max().item(),
                (g_p - g_64).abs().max().item())
    check(ctc_rel <= 1e-5, f"CTC kernel vs plain nll rel err {ctc_rel}")
    check(k64 <= max(2 * p64, CTC_GRAD_ATOL), f"CTC kernel grad vs f64 "
          f"{k64} <= max(2 x plain f32 vs f64 {p64}, {CTC_GRAD_ATOL})")
    emit({"phase": "train_kernels", "kernel": "fused_conformer_layer_train",
          "B": len(TRAIN_LENS), "T": TRAIN_T, "lens": TRAIN_LENS,
          "mask": "16-frame chunks, 4 left chunks, padding",
          "atol": KERNEL_ATOL, "grad_rtol": GRAD_RTOL, "cases": cases,
          "ctc": {"B": lg.shape[0], "T": lg.shape[1], "V": lg.shape[2],
                  "label_lens": label_lens.tolist(), "nll_rel_err": ctc_rel,
                  "grad_max_abs_err": ctc_gerr,
                  "grad_vs_f64": {"kernel": k64, "plain": p64},
                  "log_z": (-n_64).tolist()}})
    return worst, max((n_k - n_p).abs().max().item(), ctc_gerr)


def ctc_inputs(dev, seed=4):
    """CTC arguments at the flagship's loss shape: B=8, T'=299, V=4000,
    label lengths 5..40 and one of 80 (S = 161 > the TPU's 128 lanes)."""
    g = torch.Generator().manual_seed(seed)
    T = 299
    label_lens = torch.tensor([5, 10, 15, 20, 25, 30, 40, 80],
                              dtype=torch.int32)
    lens = torch.tensor([33, 90, 150, 180, 220, 250, 281, T],
                        dtype=torch.int32)
    B = len(label_lens)
    logits = (2 * torch.randn(B, T, VOCAB, generator=g)).to(dev)
    labels = torch.randint(1, VOCAB - 1, (B, 80), generator=g)
    labels[torch.arange(80)[None] >= label_lens[:, None]] = -1
    return (logits, lens.to(dev), labels.to(dev, torch.int32),
            label_lens.to(dev))


def train_vocab():
    """The flagship vocabulary size, as bench.py:61 pads it: <blank>,
    <unk>, 3997 characters, <eos>."""
    return (["<blank>", "<unk>"] + [chr(0x4e00 + i) for i in range(VOCAB - 3)]
            + ["<eos>"])


def write_train_corpus(root, vocab):
    """Synthetic speech (SyntheticTTS, 2-12 s) from 200 of the characters:
    train and test manifests sorted by duration, the vocabulary, and the
    example bundle's CMVN statistics (same fbank frontend)."""
    from masr_tpu_torch.audio.io import write_wave
    from masr_tpu_torch.audio.synth_tts import SyntheticTTS
    tts = SyntheticTTS(sample_rate=16000)
    rs = np.random.RandomState(5)
    os.makedirs(root, exist_ok=True)
    out = {}
    n_train = TRAIN_STEPS_PER_EPOCH * len(TRAIN_LENS)
    for split, n in (("train", n_train), ("test", 8)):
        rows = []
        for i in range(n):
            k = int(rs.randint(10, 60))
            text = "".join(vocab[2 + j] for j in rs.randint(0, 200, k))
            wav = tts.render(text, spk_id=i % 7)
            path = os.path.join(root, f"{split}_{i}.wav")
            write_wave(path, wav, 16000)
            rows.append({"audio_filepath": path, "text": text,
                         "duration": len(wav) / 16000})
        rows.sort(key=lambda r: r["duration"])
        out[split] = os.path.join(root, f"manifest.{split}")
        with open(out[split], "w", encoding="utf-8") as f:
            f.writelines(json.dumps(r, ensure_ascii=False) + "\n"
                         for r in rows)
    out["vocab"] = os.path.join(root, "vocabulary.txt")
    with open(out["vocab"], "w", encoding="utf-8") as f:
        f.writelines(t + "\n" for t in vocab)
    with open(os.path.join(TINY_BUNDLE, "inference.json"),
              encoding="utf-8") as f:
        tiny = json.load(f)
    out["cmvn"] = os.path.join(root, "mean_istd.json")
    with open(out["cmvn"], "w", encoding="utf-8") as f:
        json.dump({"mean": tiny["mean"], "istd": tiny["istd"]}, f)
    return out


def train_config(corpus, save_dir, max_epoch, dropout=True):
    """configs/conformer.yml as a dict (the card's Python may lack PyYAML),
    flagship widths, with warmup_steps 8 and accum_grad 2 so that the loss
    falls within the run's few dozen steps."""
    r = 0.1 if dropout else 0.0
    return {
        "encoder_conf": dict(FLAGSHIP_ENCODER, dropout_rate=r,
                             positional_dropout_rate=r,
                             attention_dropout_rate=r),
        "decoder_conf": dict(attention_heads=4, linear_units=1024,
                             num_blocks=3, r_num_blocks=3, dropout_rate=r,
                             positional_dropout_rate=r,
                             self_attention_dropout_rate=r,
                             src_attention_dropout_rate=r),
        "model_conf": dict(ctc_weight=0.3, lsm_weight=0.1,
                           reverse_weight=0.3, length_normalized_loss=False),
        "dataset_conf": dict(batch_size=len(TRAIN_LENS), num_workers=4,
                             min_duration=0.5, max_duration=20,
                             train_manifest=corpus["train"],
                             test_manifest=corpus["test"],
                             dataset_vocab=corpus["vocab"],
                             mean_istd_path=corpus["cmvn"],
                             manifest_type="txt"),
        "preprocess_conf": PREPROCESS,
        "optimizer_conf": dict(optimizer="Adam", weight_decay=1e-6,
                               learning_rate=1e-3, scheduler="WarmupLR",
                               scheduler_conf=dict(warmup_steps=8,
                                                   min_lr=1e-5)),
        "train_conf": dict(enable_amp=False, grad_clip=5.0, accum_grad=2,
                           max_epoch=max_epoch, log_interval=4),
        "use_model": "conformer", "streaming": True, "decoder": "ctc_greedy",
        "metrics_type": "cer", "log_dir": os.path.join(save_dir, "log")}


def train_layer_kernel(family="conformer"):
    """The family's training-layer kernel wrapper (its launch counts)."""
    if family == "conformer":
        from masr_tpu_torch.ops.cuda import conformer_layer_train as m
        return m.fused_conformer_layer_train
    from masr_tpu_torch.ops.cuda import squeezeformer_layer_train as m
    return m.fused_squeezeformer_layer_train


def reset_train_launches():
    from masr_tpu_torch.ops.cuda import ctc_loss as C
    for fn in (train_layer_kernel("conformer"),
               train_layer_kernel("squeezeformer"), C.ctc_loss):
        fn.launches = fn.backward_launches = 0


def train_launches(family="conformer"):
    """(train layer launches, its backward ones, CTC launches, its backward
    ones)."""
    from masr_tpu_torch.ops.cuda import ctc_loss as C
    f, c = train_layer_kernel(family), C.ctc_loss
    return (f.launches, f.backward_launches, c.launches, c.backward_launches)


@contextlib.contextmanager
def clocked_train_steps(rows, family="conformer"):
    """Wraps the trainer's train step: per step the wall time (synchronised),
    the kernel launches, loss, label tokens and audio seconds → rows."""
    from masr_tpu_torch.training import trainer as tr
    orig = tr.train_step

    def step(state, batch, seed):
        torch.cuda.synchronize()
        before = train_launches(family)
        flash_before = flash_kernel().launches
        t0 = time.perf_counter()
        m = orig(state, batch, seed)
        torch.cuda.synchronize()
        rows.append({"s": time.perf_counter() - t0, "loss": m["loss"],
                     "finite": m["finite"],
                     "tokens": float(batch["label_lens"].float().mean()),
                     "audio_s": float(batch["input_lens"].sum()) / 100.0,
                     "launches": [a - b for a, b in
                                  zip(train_launches(family), before)],
                     "flash_launches": flash_kernel().launches
                     - flash_before})
        return m

    tr.train_step = step
    try:
        yield rows
    finally:
        tr.train_step = orig


def train_and_resume(config, corpus, root, family, step_launches):
    """The main path of a training phase: MASRTrainer(dict config,
    device=cuda).train for TRAIN_EPOCHS epochs of 16 steps, then a second
    trainer resumes from last_model for one more; every step must launch
    step_launches (train layer, its backward, CTC, its backward); the loss
    per label token and the test loss must fall. Counts are read around the
    two train() calls alone. → (launches of the run, per-step rows, the
    resumed trainer, checkpoint metas, summary dict)."""
    from masr_tpu_torch.training.trainer import MASRTrainer
    save = os.path.join(root, "models")
    rows = []
    reset_train_launches()
    with clocked_train_steps(rows, family):
        t0 = time.perf_counter()
        MASRTrainer(config(corpus, root, TRAIN_EPOCHS),
                    device="cuda").train(save_model_path=save)
        first_s = time.perf_counter() - t0
        resumed = MASRTrainer(config(corpus, root, TRAIN_EPOCHS + 1),
                              device="cuda")
        resumed.train(save_model_path=save)
    launches = train_launches(family)
    steps = TRAIN_STEPS_PER_EPOCH * (TRAIN_EPOCHS + 1)
    check(len(rows) == steps and resumed.state.step == steps,
          f"{len(rows)} steps, resumed state at step {resumed.state.step}, "
          f"want {steps}")
    for i, r in enumerate(rows):
        check(r["launches"] == list(step_launches),
              f"{family} step {i} launches {r['launches']}, want "
              f"{list(step_launches)} (train layer, its backward, CTC, its "
              f"backward)")
    losses = np.asarray([r["loss"] for r in rows])
    per_token = losses / np.asarray([r["tokens"] for r in rows])
    check(bool(np.isfinite(losses).all()) and all(r["finite"] for r in rows),
          "every step's loss finite")
    head, tail = float(per_token[:4].mean()), float(per_token[-8:].mean())
    check(tail < head, f"{family} loss per label token falls: first 4 steps "
          f"{head}, last 8 {tail}")
    run = os.path.join(save, f"{family}_streaming_fbank")
    metas = {}
    for d in ("epoch_1", "epoch_2", "epoch_3", "last_model", "best_model"):
        check(os.path.exists(os.path.join(run, d, "state.pt")),
              f"checkpoint {d} written")
        with open(os.path.join(run, d, "model.state")) as f:
            metas[d] = json.load(f)
    check(metas["last_model"]["last_epoch"] == TRAIN_EPOCHS + 1,
          "resume went on to epoch 3")
    test_losses = [metas[f"epoch_{e}"]["test_loss"] for e in (1, 2, 3)]
    check(test_losses[2] < test_losses[0], f"{family} test loss falls over "
          f"the epochs: {test_losses}")
    summary = {"steps": len(rows), "batch": len(TRAIN_LENS),
               "epochs": TRAIN_EPOCHS + 1,
               "resumed_from_epoch": TRAIN_EPOCHS,
               "launches": {"train_layer_fwd_bwd": launches[0],
                            "train_layer_bwd": launches[1],
                            "ctc_fwd_bwd": launches[2],
                            "ctc_bwd": launches[3]},
               "loss_first": float(losses[0]), "loss_last": float(losses[-1]),
               "loss_per_token_first4": head, "loss_per_token_last8": tail,
               "test_loss_per_epoch": test_losses,
               "test_cer_last": metas["last_model"].get("test_cer"),
               "first_two_epochs_s": first_s}
    return launches, rows, resumed, summary


def first_step_card_vs_cpu(conf, sample, prepare=None):
    """The first train step at dropout 0 from the same init and batch on
    the card and on the CPU: the loss (rel CPU_LOSS_RTOL), the grads of the
    sampled parameters and every BatchNorm running statistic after the step
    (rel CPU_GRAD_RTOL of their largest magnitude). The sample leaves out
    the subsampling convs and the decoder's layers, whose grads pass
    through a ReLU's derivative: where a pre-activation within f32 rounding
    of 0 takes the other side on the card, such a grad jumps past the
    tolerance (so does the CPU's in f32 against f64), so it is no
    continuous function to compare elementwise; the sampled grads take such
    jumps only summed over every row. prepare(model) runs on both models
    first. → summary dict."""
    from masr_tpu_torch.training.train_state import batch_to, step_generators
    from masr_tpu_torch.training.trainer import MASRTrainer
    trainers = {}
    for name in ("card", "cpu"):
        t = MASRTrainer(conf, device="cuda" if name == "card" else "cpu")
        ds, _, loader = t._setup_dataloader(True)
        t._setup_model(ds.feature_dim, ds.vocab_size)
        if prepare is not None:
            prepare(t.model)
        trainers[name] = t
    batch = next(iter(loader))
    got = {}
    for name, t in trainers.items():
        b = batch_to(batch, t.device)
        gen, chunk = step_generators(0, 0, t.device)
        out = t.model.train()(b["inputs"], b["input_lens"], b["labels"],
                              b["label_lens"], generator=gen,
                              chunk_generator=chunk)
        out["loss"].backward()
        got[name] = (float(out["loss"].detach()),
                     {n: p.grad.detach().cpu()
                      for n, p in t.model.named_parameters()},
                     {n: b.detach().cpu()
                      for n, b in t.model.named_buffers()
                      if n.endswith(("running_mean", "running_var"))})
    (l_card, g_card, s_card), (l_cpu, g_cpu, s_cpu) = got["card"], got["cpu"]
    loss_rel = abs(l_card - l_cpu) / abs(l_cpu)
    check(loss_rel <= CPU_LOSS_RTOL, f"first-step loss card {l_card} vs CPU "
          f"{l_cpu}: rel {loss_rel} <= {CPU_LOSS_RTOL}")
    grad_rel = {n: rel_err(g_card[n], g_cpu[n]) for n in sample}
    stat_rel = {n: rel_err(s_card[n], s_cpu[n]) for n in s_cpu}
    for n, e in {**grad_rel, **stat_rel}.items():
        check(e <= CPU_GRAD_RTOL, f"first step {n} card vs CPU: {e} <= "
              f"{CPU_GRAD_RTOL} of its max")
    return {"loss_card": l_card, "loss_cpu": l_cpu, "loss_rel_err": loss_rel,
            "grad_rel_err": grad_rel,
            "batch_stats_rel_err_max": max(stat_rel.values(), default=None)}


def phase_train(dev):
    """MASRTrainer(dict config, device=cuda).train at flagship widths on a
    synthetic corpus: 2 epochs of 16 steps at B=8, then a resume for a third
    epoch; the first step's loss and grads against the CPU at dropout 0."""
    root = os.path.join(WORK, "train")
    shutil.rmtree(root, ignore_errors=True)
    corpus = write_train_corpus(os.path.join(root, "corpus"), train_vocab())
    n_layers = FLAGSHIP_ENCODER["num_blocks"]
    launches, rows, resumed, summary = train_and_resume(
        train_config, corpus, root, "conformer", (2 * n_layers, n_layers, 2, 1))
    sample = ["encoder.embed.out.0.weight",
              "encoder.encoders.0.feed_forward.w_1.weight",
              f"encoder.encoders.{n_layers // 2}.self_attn.linear_q.weight",
              f"encoder.encoders.{n_layers - 1}.conv_module.depthwise_conv"
              ".weight",
              f"encoder.encoders.{n_layers - 1}.norm_final.weight",
              "decoder.left_decoder.after_norm.weight",
              "decoder.right_decoder.output_layer.weight",
              "ctc.ctc_lo.weight"]
    first = first_step_card_vs_cpu(
        train_config(corpus, root, 1, dropout=False), sample)
    emit({"phase": "train", **summary, "first_step_card_vs_cpu": first})
    return launches, rows, resumed, corpus


# the training layer's GEMMs are common.cuh's tensor-core gemm_tc_kernel
# instantiated with its epilogue functor Epi (the serving kernels' FMA
# gemm_kernel takes ServeEpi)
PROFILE_GROUPS = (("train layer: GEMMs", ("::Epi>", "splitk_sum_kernel")),
                  ("train layer: attention softmax", ("att_softmax",)),
                  ("train layer: column sums", ("colsum_kernel",)),
                  ("train layer: LayerNorm", ("layer_norm_kernel",
                                              "ln_bwd_kernel")),
                  ("train layer: conv module", ("conv_",)),
                  ("train layer: elementwise", ("scale_drop_kernel",
                                                "add_kernel", "ada_")),
                  ("CTC kernel", ("ctc_",)))


def profile_train_steps(trainer, n=3):
    """torch.profiler over n train steps of `trainer` on the batch of the 8
    longest training utterances: device kernel time by group, device busy
    time against the steps' wall time."""
    from torch.profiler import ProfilerActivity, profile
    from masr_tpu_torch.data.collate import collate_fn
    from masr_tpu_torch.training import train_state as ts
    ds = trainer._setup_dataloader(True)[0]
    items = [ds[i] for i in range(len(ds) - len(TRAIN_LENS), len(ds))]
    batch = ts.batch_to(collate_fn(items, rng=np.random.RandomState(0)),
                        trainer.device)
    for _ in range(2):
        ts.train_step(trainer.state, batch, 0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            ts.train_step(trainer.state, batch, 0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    groups, top = {}, []
    for ev in prof.key_averages():
        # kernels only: CPU ops (autograd functions, Adam.step) also carry
        # the device time of the kernels they launch
        if "CUDA" not in str(getattr(ev, "device_type", "")):
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0.0)
        if us <= 0:
            continue
        top.append((ev.key[:80], us / 1e3 / n))
        name = next((g for g, keys in PROFILE_GROUPS
                     if any(k in ev.key for k in keys)),
                    "PyTorch kernels (subsampling, decoder, CTC head, "
                    "optimizer, copies)")
        groups[name] = groups.get(name, 0.0) + us / 1e3 / n
    busy = sum(groups.values())
    top.sort(key=lambda kv: -kv[1])
    return {"steps": n, "B": int(batch["inputs"].shape[0]),
            "T_in": int(batch["inputs"].shape[1]),
            "audio_s": float(batch["input_lens"].sum()) / 100.0,
            "wall_ms_per_step": wall / n * 1e3,
            "device_busy_ms_per_step": busy if busy else "not measured",
            "idle_share": 1 - busy / (wall / n * 1e3) if busy
            else "not measured",
            "by_group_ms_per_step": groups, "top": top[:20]}


def time_train_layer(fns, layer, args, rates):
    """Forward and backward of the training layer, fns["kernel"] vs
    fns["plain"], CUDA events in the order plain, kernel, kernel, plain →
    ({name: [fwd ms]}, {name: [bwd ms]})."""
    fwd, bwd = {"plain": [], "kernel": []}, {"plain": [], "kernel": []}
    for name in ("plain", "kernel", "kernel", "plain"):
        y = run_train_layer(fns[name], layer, args, rates)[0]
        fwd[name].append(cuda_ms(lambda: run_train_layer(
            fns[name], layer, args, rates)))
        bwd[name].append(cuda_ms(lambda: y.backward(args[1],
                                                    retain_graph=True)))
        del y
    return fwd, bwd


def step_times(rows):
    """Train-step wall times of a run: the median after the first three
    steps, every step's, and the audio seconds trained per second."""
    steady = rows[3:]
    return {"step_s_median": float(np.median([r["s"] for r in steady])),
            "step_s": [r["s"] for r in rows],
            "audio_s_per_s": sum(r["audio_s"] for r in steady) / sum(
                r["s"] for r in steady)}


def phase_train_times(dev, rows, trainer, smi):
    """Training-layer forward and backward, kernel vs plain, and CTC
    forward + backward, kernel vs plain vs F.ctc_loss, at B=8, T'=299
    (CUDA events, plain, kernel, kernel, plain); step wall times of the
    train phase; a torch.profiler breakdown of three train steps."""
    import torch.nn.functional as F
    from masr_tpu_torch.ops.cuda import conformer_layer_train as clt
    from masr_tpu_torch.ops.cuda import ctc_loss as C
    layer = seeded_layer(23, True, dev)
    args = train_layer_inputs(layer, 24, dev)
    rates = (0.1, 0.1)
    fwd, bwd = time_train_layer(
        {"plain": clt.fused_conformer_layer_train_plain,
         "kernel": clt.fused_conformer_layer_train}, layer, args, rates)
    lg, lens, labels, label_lens = ctc_inputs(dev, seed=6)
    lp_lens, tl = lens.long(), label_lens.long()
    targets = labels.clamp(min=0).long()

    def ctc_kernel():
        x = lg.clone().requires_grad_(True)
        C.ctc_loss(x, lens, labels, label_lens).sum().backward()

    def ctc_plain():
        x = lg.clone().requires_grad_(True)
        C.ctc_loss_plain(x, lens, labels, label_lens).sum().backward()

    def ctc_library():
        x = lg.clone().requires_grad_(True)
        F.ctc_loss(torch.log_softmax(x, -1).transpose(0, 1), targets, lp_lens,
                   tl, reduction="none").sum().backward()

    ctc = {"plain": [cuda_ms(ctc_plain, 5)], "kernel": [cuda_ms(ctc_kernel)]}
    ctc["kernel"].append(cuda_ms(ctc_kernel))
    ctc["plain"].append(cuda_ms(ctc_plain, 5))
    ctc["library"] = [cuda_ms(ctc_library)]
    layer_b = train_layer_bound(layer, args)
    ctc_b = ctc_bound(lg)
    emit({"phase": "train_times", "card": smi,
          "train_layer": {"B": len(TRAIN_LENS), "T": TRAIN_T,
                          "rates": rates, "fwd_kernel_ms": fwd["kernel"],
                          "fwd_plain_ms": fwd["plain"],
                          "bwd_kernel_ms": bwd["kernel"],
                          "bwd_plain_ms": bwd["plain"], **layer_b},
          "ctc": {"B": lg.shape[0], "T": lg.shape[1], "V": lg.shape[2],
                  "fwd_bwd_kernel_ms": ctc["kernel"],
                  "fwd_bwd_plain_ms": ctc["plain"],
                  "fwd_bwd_library_ms": ctc["library"], **ctc_b},
          **step_times(rows), "profile": profile_train_steps(trainer)})
    return ({"ms": float(np.mean(fwd["kernel"]) + np.mean(bwd["kernel"])),
             "plain_ms": float(np.mean(fwd["plain"]) + np.mean(bwd["plain"])),
             **layer_b},
            {"ms": float(np.mean(ctc["kernel"])),
             "plain_ms": float(np.mean(ctc["plain"])),
             "library_ms": float(np.mean(ctc["library"])), **ctc_b})


# --------------------------------------------------------------------------- #
# Squeezeformer training: its training-layer kernel, MASRTrainer.train
# --------------------------------------------------------------------------- #
def phase_sq_train_kernels(dev):
    """The Squeezeformer training-layer kernel vs its plain twin at the
    width of configs/squeezeformer.yml with the layer_norm conv (D=256, 4
    heads, FFN 2048, conv 31), B=8, the dynamic-chunk mask with padding:
    full rate (T'=299) and half rate (T'=150, the rows after the time
    reduction), dropout 0 and 0.1 / 0.1; output and every grad."""
    from masr_tpu_torch.ops.cuda import squeezeformer_layer_train as sqt
    layer = seeded_sq_layer(31, True, "layer_norm", dev)
    fns = (sqt.fused_squeezeformer_layer_train,
           sqt.fused_squeezeformer_layer_train_plain)
    cases = [check_train_layer(fns, layer,
                               train_layer_inputs(layer, 32, dev, half),
                               rates)
             for half in (False, True) for rates in ((0.0, 0.0), (0.1, 0.1))]
    emit({"phase": "sq_train_kernels",
          "kernel": "fused_squeezeformer_layer_train", "B": len(TRAIN_LENS),
          "lens": TRAIN_LENS, "D": 256, "heads": 4, "ffn": 2048,
          "conv_kernel": 31,
          "mask": "16-frame chunks, 4 left chunks, padding; half rate: its "
                  "[::2, ::2]", "atol": KERNEL_ATOL, "grad_rtol": GRAD_RTOL,
          "cases": cases})
    return max(c["max_abs_err"] for c in cases)


def sq_train_config(corpus, save_dir, max_epoch, dropout=True,
                    conv_norm="layer_norm"):
    """configs/squeezeformer.yml as a dict at its widths with the given
    cnn_norm_type (no repo config gives this family layer_norm), B=8,
    accum_grad 2, its AdamW and NoamHoldAnnealing with max_steps cut to the
    run's 24 updates (48 steps) so that the loss falls within the run."""
    r = 0.1 if dropout else 0.0
    conf = train_config(corpus, save_dir, max_epoch, dropout)
    conf.update({
        "encoder_conf": dict(SQ_ENCODER, cnn_norm_type=conv_norm, dropout=r,
                             input_dropout_rate=r,
                             feed_forward_dropout_rate=r,
                             attention_dropout_rate=r),
        "decoder_conf": dict(SQ_DECODER, dropout_rate=r,
                             positional_dropout_rate=r,
                             self_attention_dropout_rate=r,
                             src_attention_dropout_rate=r),
        "optimizer_conf": dict(
            optimizer="AdamW", weight_decay=4e-5, learning_rate=1e-3,
            scheduler="NoamHoldAnnealing",
            scheduler_conf=dict(
                max_steps=TRAIN_STEPS_PER_EPOCH * (TRAIN_EPOCHS + 1) // 2,
                warmup_ratio=0.2, hold_ratio=0.3, decay_rate=1.0,
                min_lr=1e-5)),
        "use_model": "squeezeformer"})
    return conf


def no_positional_dropout(model):
    """The Squeezeformer subsampling's positional dropout, which masr_tpu
    keeps at 0.1 whatever the config, off: the card's and the CPU's
    generators draw other numbers."""
    model.encoder.embed.pos_enc.dropout_rate = 0.0


def phase_sq_train(dev, corpus):
    """MASRTrainer(dict config, device=cuda).train of the Squeezeformer of
    configs/squeezeformer.yml with the layer_norm conv on phase 12's
    corpus: 2 epochs of 16 steps at B=8 and a resumed third, every step
    12 + 12 training-layer launches and 1 + 1 CTC, the loss per label token
    and the test loss falling; its first step at dropout 0 against the CPU.
    Then one epoch of the BatchNorm default: no training-layer launch, the
    running statistics moved, its first step (statistics included) against
    the CPU."""
    from masr_tpu_torch.training.trainer import MASRTrainer
    root = os.path.join(WORK, "sq_train")
    shutil.rmtree(root, ignore_errors=True)
    n = SQ_ENCODER["num_blocks"]
    launches, rows, resumed, summary = train_and_resume(
        sq_train_config, corpus, root, "squeezeformer", (2 * n, n, 2, 1))
    sample = ["encoder.embed.input_proj.0.weight", "encoder.preln.weight",
              "encoder.encoders.0.self_attn.ada_scale",
              "encoder.encoders.0.ffn1.w_1.weight",
              f"encoder.encoders.{n // 2}.self_attn.linear_q.weight",
              f"encoder.encoders.{n // 2}.conv_module.ada_bias",
              "encoder.time_reduction_layer.pw_conv.weight",
              "encoder.time_recover_layer.weight",
              f"encoder.encoders.{n - 1}.conv_module.depthwise_conv.weight",
              f"encoder.encoders.{n - 1}.layer_norm4.weight",
              "decoder.left_decoder.after_norm.weight",
              "decoder.right_decoder.output_layer.weight",
              "ctc.ctc_lo.weight"]
    first = first_step_card_vs_cpu(
        sq_train_config(corpus, root, 1, dropout=False), sample,
        no_positional_dropout)

    # the BatchNorm default: the eager layers with batch statistics
    bn_root = os.path.join(root, "batch_norm")
    bn_rows = []
    bn = MASRTrainer(sq_train_config(corpus, bn_root, 1,
                                     conv_norm="batch_norm"), device=dev)
    reset_train_launches()
    flash_kernel().launches = 0
    with clocked_train_steps(bn_rows, "squeezeformer"):
        bn.train(save_model_path=os.path.join(bn_root, "models"))
    bn_launches = train_launches("squeezeformer")
    # the validation pass (no grad) runs the eager attention through the
    # flash kernel; a train step records autograd, so it never does
    bn_flash = flash_kernel().launches
    check(len(bn_rows) == TRAIN_STEPS_PER_EPOCH, f"{len(bn_rows)} BatchNorm "
          f"steps, want {TRAIN_STEPS_PER_EPOCH}")
    for i, r in enumerate(bn_rows):
        check(r["launches"] == [0, 0, 2, 1], f"BatchNorm step {i} launches "
              f"{r['launches']}: no training-layer kernel, CTC 1 + 1")
        check(r["flash_launches"] == 0, f"BatchNorm step {i}: "
              f"{r['flash_launches']} flash launches under autograd")
    check(bn_flash > 0 and bn_flash % n == 0, f"{bn_flash} flash launches "
          f"in the BatchNorm run's validation: {n} per encode")
    check(all(r["finite"] for r in bn_rows), "BatchNorm steps finite")
    stats = {k: v for k, v in bn.model.state_dict().items()
             if k.endswith(("running_mean", "running_var"))}
    moved = min(float((v - (1.0 if k.endswith("var") else 0.0)).abs().max())
                for k, v in stats.items())
    check(len(stats) == 2 * n and moved > 0, f"{len(stats)} BatchNorm "
          f"statistics, each moved off its init (least max move {moved})")
    bn_first = first_step_card_vs_cpu(
        sq_train_config(corpus, bn_root, 1, dropout=False,
                        conv_norm="batch_norm"),
        sample + [f"encoder.encoders.{n // 2}.conv_module.norm.weight"],
        no_positional_dropout)
    emit({"phase": "sq_train", "cnn_norm_type": "layer_norm", **summary,
          "first_step_card_vs_cpu": first,
          "batch_norm": {"steps": len(bn_rows),
                         "launches": bn_launches,
                         "validation_flash_launches": bn_flash,
                         "loss": [r["loss"] for r in bn_rows],
                         "stats_least_max_move": moved,
                         **step_times(bn_rows),
                         "first_step_card_vs_cpu": bn_first}})
    return launches, rows, resumed


def phase_sq_train_times(dev, rows, trainer, smi):
    """The Squeezeformer training layer forward and backward, kernel vs
    plain, at B=8, full rate (T'=299) and half rate (T'=150), dropout 0.1
    (CUDA events, plain, kernel, kernel, plain), with their bounds; the
    train-step wall times and audio seconds per second of sq_train; a
    torch.profiler breakdown of three steps on the longest batch."""
    from masr_tpu_torch.ops.cuda import squeezeformer_layer_train as sqt
    layer = seeded_sq_layer(33, True, "layer_norm", dev)
    fns = {"plain": sqt.fused_squeezeformer_layer_train_plain,
           "kernel": sqt.fused_squeezeformer_layer_train}
    rates, out = (0.1, 0.1), {}
    for rate_name, half in (("full_rate", False), ("half_rate", True)):
        args = train_layer_inputs(layer, 34, dev, half)
        fwd, bwd = time_train_layer(fns, layer, args, rates)
        out[rate_name] = {
            "T": int(args[0].shape[1]), "fwd_kernel_ms": fwd["kernel"],
            "fwd_plain_ms": fwd["plain"], "bwd_kernel_ms": bwd["kernel"],
            "bwd_plain_ms": bwd["plain"],
            "ms": float(np.mean(fwd["kernel"]) + np.mean(bwd["kernel"])),
            "plain_ms": float(np.mean(fwd["plain"]) + np.mean(bwd["plain"])),
            **train_layer_bound(layer, args)}
    emit({"phase": "sq_train_times", "card": smi, "B": len(TRAIN_LENS),
          "rates": rates, "train_layer": out, **step_times(rows),
          "profile": profile_train_steps(trainer)})
    return out["full_rate"]


def train_layer_bound(layer, args):
    """Forward + backward of one training layer (Conformer or Squeezeformer:
    the same products) over the valid rows: the forward's products,
    attention over the mask's visible (query, key) pairs of valid rows,
    depthwise conv; the backward twice the forward's operations. Bytes: x,
    mask, posp, weights and dy in; y, dx, dposp and the weight grads out,
    each once."""
    x, _, mask, _, lens, posp, packed = args
    D, F, K = layer.size, packed["ffw1"].shape[2], layer.cnn_module_kernel
    M = int(lens.sum())
    pairs = int(mask.sum())
    fwd = (8 * M * D * F + 8 * M * D * D + 6 * M * D * D + 2 * M * D * K
           + 6 * D * pairs)
    w = _weight_bytes(layer)
    nbytes = 2 * w + mask.numel() + 4 * (4 * x.numel() + 2 * posp.numel())
    return {**_bound(3 * fwd, nbytes), **_bound_3xtf32(3 * fwd, nbytes)}


def ctc_bound(logits):
    """CTC forward + backward: the (B, T, V) logits read once and their
    grads written once; ~10 operations per logit (max, exp, sums, the grad
    row)."""
    return _bound(10 * logits.numel(), 2 * 4 * logits.numel())


# --------------------------------------------------------------------------- #
# static-chunk recognition: the masked rel-pos flash attention
# --------------------------------------------------------------------------- #
STATIC_CHUNK = 16
FLASH_T = (37, 299, 800, 1500, 3000)
FLASH_MASKS = ("full", "static16", "static16_left4", "half_rate", "random")
FLASH_SWEEP_T = (150, 299, 800, 1500, 3000)


def flash_mask(kind, lens, T, dev):
    """(B, T, T) bool mask of one kind: `full` (the pad mask's broadcast
    expand view), `static16` (chunks of 16, every left chunk: the main
    path's), `static16_left4` (4 left chunks: padded rows past them see no
    key), `half_rate` (the [::2, ::2] view of a 2T static16 mask, lengths
    doubled), `random` (30% of the pairs; every 7th row and the key tile
    [32, 64) hidden; utterance 1 sees one key)."""
    from masr_tpu_torch.ops.masks import (add_optional_chunk_mask,
                                          make_pad_mask)
    if kind == "half_rate":
        return flash_mask("static16", [2 * n for n in lens], 2 * T,
                          dev)[:, ::2, ::2]
    if kind == "random":
        g = torch.Generator().manual_seed(T)
        m = torch.rand(len(lens), T, T, generator=g) < 0.3
        m[:, ::7] = False
        m[:, :, 32:64] = False
        m[1] = False
        m[1, :, T // 2] = True
        return m.to(dev)
    pad = ~make_pad_mask(torch.tensor(lens, device=dev), T)[:, None, :]
    chunk, left = {"full": (0, -1), "static16": (STATIC_CHUNK, -1),
                   "static16_left4": (STATIC_CHUNK, 4)}[kind]
    return add_optional_chunk_mask(T, pad, False, False, -1, chunk, left)


def flash_inputs(B, T, d, seed, dev, H=4):
    """q, k, v as the attention module passes them, (B, T, H d) rows viewed
    as (B, H, T, d) heads; p the (H, T, d) view of (T, H d) rows; bias_u,
    bias_v (H, d)."""
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(B, T, H * d, generator=g).to(dev).view(
        B, T, H, d).transpose(1, 2) for _ in range(3))
    p = torch.randn(T, H * d, generator=g).to(dev).view(T, H, d).transpose(
        0, 1)
    bu, bv = ((0.1 * torch.randn(H, d, generator=g)).to(dev)
              for _ in range(2))
    return q, k, v, p, bu, bv


def check_flash(args, mask, what):
    """The kernel vs its twin on the same inputs: finite, max abs err <=
    KERNEL_ATOL, rows that see no key exactly 0, the pre-pass's tile map
    equal to the plain map. → (max abs err, rows that see no key)."""
    from masr_tpu_torch.ops.cuda import rel_pos_attention as rpa
    nt = -(-mask.shape[1] // rpa.TILE)
    tmap = torch.empty(mask.shape[0], nt, nt, dtype=torch.uint8,
                       device=mask.device)
    with torch.no_grad():
        got = rpa.rel_pos_flash_attention(*args, mask, tile_map_out=tmap)
        want = rpa.rel_pos_attention_plain(*args, mask)
    torch.cuda.synchronize()
    check(torch.equal(tmap, rpa.mask_tile_map_plain(mask)),
          f"flash tile map == plain map ({what})")
    check(bool(torch.isfinite(got).all()), f"flash output finite ({what})")
    err = (got - want).abs().max().item()
    check(err <= KERNEL_ATOL, f"flash kernel vs plain max abs err {err} <= "
          f"{KERNEL_ATOL} ({what})")
    empty = ~mask.any(-1)
    check(bool((got.transpose(1, 2)[empty] == 0.0).all()),
          f"rows with no visible key exactly 0 ({what})")
    return err, int(empty.sum())


def phase_flash_kernels(dev):
    """The flash kernel vs its twin: every mask kind at d_k 64 over FLASH_T,
    and at d_k 32 and 128 at T'=299; B=4 ragged, 4 heads."""
    cases, worst = [], 0.0
    for T, d in [(T, 64) for T in FLASH_T] + [(299, 32), (299, 128)]:
        lens = [T, T - 17, max(T // 3, 1), 0]
        for kind in FLASH_MASKS:
            mask = flash_mask(kind, lens, T, dev)
            err, empty = check_flash(flash_inputs(4, T, d, T + d, dev), mask,
                                     f"{kind}, T'={T}, d_k={d}")
            cases.append({"T": T, "d_k": d, "mask": kind,
                          "rows_without_key": empty, "max_abs_err": err})
            worst = max(worst, err)
    emit({"phase": "flash_kernels", "kernel": "rel_pos_flash_attention",
          "B": 4, "heads": 4, "atol": KERNEL_ATOL, "cases": cases})
    return worst


def long_utterances(vocab):
    """4 utterances of 160..298 characters: 32 s to 60 s of audio."""
    from masr_tpu_torch.audio.synth_tts import SyntheticTTS
    tts = SyntheticTTS(sample_rate=16000)
    rs = np.random.RandomState(2)
    return [tts.render("".join(vocab[j] for j in
                               rs.randint(2, len(vocab) - 1, n)), spk_id=i)
            for i, n in enumerate(np.linspace(160, 298, 4).astype(int))]


def encode_launches():
    """(flash, Conformer layer kernel, Squeezeformer layer kernel)."""
    return (flash_kernel().launches, layer_kernel("conformer").launches,
            layer_kernel("squeezeformer").launches)


def phase_static_flagship(dev, family):
    """A static-chunk flagship: the predictor's warmup, predict_batch of the
    8 utterances (the main path) and of 4 long ones, predict of one; each
    encode launches the flash kernel once per layer and no full-context
    layer kernel; probs card vs CPU. → (card predictor, long utterances,
    the main path's flash launches)."""
    from masr_tpu_torch.infer.predictor import MASRPredictor
    path = os.path.join(WORK, f"{family}_static_bundle")
    vocab = write_flagship_bundle(path, family, static_chunk=STATIC_CHUNK)
    wavs, long = synthetic_utterances(vocab), long_utterances(vocab)
    n = FLAGSHIP_ENCODER["num_blocks"]
    per_encode = (n, 0, 0)
    reset_launches()
    gpu = MASRPredictor(model_dir=path, device=dev)    # warmup: predict
    warm = encode_launches()
    check(warm == per_encode, f"{family} static warmup launches {warm} == "
          f"{per_encode} (flash, layer kernels)")
    cpu = MASRPredictor(model_dir=path, device="cpu", warmup=False)
    runs = {}
    for name, batch in (("batch", wavs), ("long_batch", long)):
        # the main path: counts read around predict_batch alone
        reset_launches()
        t0 = time.perf_counter()
        texts = gpu.predict_batch(batch)
        wall = time.perf_counter() - t0
        got = encode_launches()
        check(got == per_encode, f"{family} static predict_batch launches "
              f"{got} == {per_encode} (flash, layer kernels), {name}")
        err, compared, t_out = probs_card_vs_cpu(gpu, cpu, batch)
        cpu_texts = cpu.predict_batch(batch)
        runs[name] = {"utterances": len(batch),
                      "seconds_audio": [round(len(w) / 16000, 3)
                                        for w in batch],
                      "T_out": t_out, "launches": got[0],
                      "probs_max_abs_err": err,
                      "argmax_frames_compared": compared,
                      "texts_equal_cpu": sum(a["text"] == b["text"] for a, b
                                             in zip(texts, cpu_texts)),
                      "predict_batch_s": wall}
    reset_launches()
    one = gpu.predict(wavs[0])
    got = encode_launches()
    check(got == per_encode and bool(one["text"]), f"{family} static "
          f"predict launches {got} == {per_encode}, text not empty")
    emit({"phase": "static_flagship", "family": family,
          "streaming": gpu.streaming, "static_chunk_size": STATIC_CHUNK,
          "warmup_launches": warm[0], "probs_atol": PROBS_ATOL, **runs,
          "predict_text_equal_cpu": one["text"] == cpu.predict(
              wavs[0])["text"]})
    return gpu, long, runs["batch"]["launches"]


def flash_bound(mask, B, H, T, d):
    """Operations over the (query, key) pairs the mask lets through: per
    pair and head [q+u | q+v].[k | p] (4 d) and P.V (2 d); the dense count
    beside it. Bytes: q, k, v, out (B, H, T, d) and p (H, T, d) f32, the
    mask (one byte per pair), each once."""
    pairs = int(mask.sum())
    dense = 6 * d * H * B * T * T
    nbytes = 4 * (4 * B * H * T * d + H * T * d) + B * T * T
    return {**_bound(6 * d * H * pairs, nbytes),
            **_bound_3xtf32(6 * d * H * pairs, nbytes),
            "visible_pairs": pairs,
            "dense_gflop": dense / 1e9,
            "dense_bound_ms": dense / PEAK_F32_FLOPS * 1e3}


def sdpa_backend(call):
    """The backend F.scaled_dot_product_attention takes for `call`, by the
    dispatcher's own rule: the first backend, in torch's priority order and
    among those enabled by default, that accepts the inputs when it is the
    only one allowed."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    cuda = torch.backends.cuda
    enabled = {
        SDPBackend.FLASH_ATTENTION: cuda.flash_sdp_enabled(),
        SDPBackend.EFFICIENT_ATTENTION: cuda.mem_efficient_sdp_enabled(),
        SDPBackend.CUDNN_ATTENTION: cuda.cudnn_sdp_enabled(),
        SDPBackend.MATH: cuda.math_sdp_enabled()}
    order = getattr(torch._C, "_get_sdp_priority_order", lambda: [1, 2, 0])()
    for b in (SDPBackend(i) for i in order):
        if not enabled.get(b, False):
            continue
        try:
            with sdpa_kernel([b]):
                call()
            return b.name
        except RuntimeError:
            continue
    return "not measured"


def phase_flash_times(dev, smi, static_runs):
    """The flash kernel vs its twin and the library call, CUDA events
    (plain, kernel, kernel, plain; SDPA twice after), at B=8 under the
    static-16 mask, lengths T' down to 0.53 T' (1500 → 800 at the main shape), over
    FLASH_SWEEP_T; SDPA compared on rows that see a key; the long batch's
    predict_batch wall for each static flagship."""
    import torch.nn.functional as F
    from masr_tpu_torch.ops.cuda import rel_pos_attention as rpa
    B, H, d = 8, 4, 64
    sweep = {}
    for T in FLASH_SWEEP_T:
        lens = np.linspace(T, round(0.533 * T), B).round().astype(int)
        lens = [int(n) for n in lens]
        mask = flash_mask("static16", lens, T, dev)
        args = flash_inputs(B, T, d, 40 + T, dev)
        q, k, v, p, bu, bv = args

        def kernel():
            return rpa.rel_pos_flash_attention(*args, mask)

        def plain():
            return rpa.rel_pos_attention_plain(*args, mask)

        with torch.no_grad():
            err = check_flash(args, mask, f"timed, T'={T}")[0]
            runs = alternate(kernel, plain)
            # the library call on the same function: [q+u | q+v].[k | p]^T
            q_cat = torch.cat([q + bu[None, :, None], q + bv[None, :, None]],
                              dim=-1)
            k_cat = torch.cat([k, p[None].expand(B, -1, -1, -1)], dim=-1)
            m4 = mask[:, None]

            def library():
                return F.scaled_dot_product_attention(
                    q_cat, k_cat, v, attn_mask=m4, scale=1.0 / d ** 0.5)

            seen = mask.any(-1)                                  # (B, T)
            lib_err = (library().transpose(1, 2)[seen]
                       - kernel().transpose(1, 2)[seen]).abs().max().item()
            lib_ms = [cuda_ms(library), cuda_ms(library)]
            backend = sdpa_backend(library)
            dev_ms = {"kernel": device_ms(kernel), "sdpa": device_ms(library)}
        sweep[T] = {"B": B, "heads": H, "d_k": d, "T": T, "lens": lens,
                    "max_abs_err": err, "kernel_ms": runs["kernel"],
                    "plain_ms": runs["plain"], "sdpa_ms": lib_ms,
                    "sdpa_backend": backend,
                    "sdpa_max_abs_err": lib_err,
                    "kernel_device_ms": dev_ms["kernel"],
                    "sdpa_device_ms": dev_ms["sdpa"],
                    **flash_bound(mask, B, H, T, d)}
    walls, long = {}, static_runs["conformer"][1]
    for family, (gpu, _) in static_runs.items():
        walls[family] = []
        for _ in range(3):
            t0 = time.perf_counter()
            gpu.predict_batch(long)
            walls[family].append(time.perf_counter() - t0)
    emit({"phase": "flash_times", "card": smi, "mask": "static chunk 16",
          "sweep": [sweep[T] for T in FLASH_SWEEP_T],
          "long_predict_batch_s": walls,
          "long_audio_s": round(sum(len(w) for w in long) / 16000, 3)})
    main = sweep[1500]
    return {"ms": float(np.mean(main["kernel_ms"])),
            "plain_ms": float(np.mean(main["plain_ms"])),
            "library_ms": float(np.mean(main["sdpa_ms"])),
            "max_abs_err": max(v["max_abs_err"] for v in sweep.values()),
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"]}


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from masr_tpu_torch.ops.cuda import build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = card()

    t_start = t0 = time.perf_counter()
    built = build.build(["conformer_layer", "chunk_layer",
                         "squeezeformer_layer", "chunk_layer_sq",
                         "conformer_layer_train", "ctc_loss",
                         "squeezeformer_layer_train", "rel_pos_attention"])
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

    train_err, ctc_err = phase_train_kernels(dev)
    t_launches, rows, trainer, corpus = phase_train(dev)
    t_layer, t_ctc = phase_train_times(dev, rows, trainer, smi)

    sq_worst, sq_chunk_worst = phase_sq_kernels(dev)
    sq_gpu, _, sq_launches = phase_flagship(dev, "squeezeformer")
    sq_path = write_stream_bundle(sq_gpu.model_dir)
    phase_stream(dev, sq_path, wavs[3], "squeezeformer")
    sq_chunk_launches = phase_engine(dev, sq_path, wavs, "squeezeformer")
    sq_t, sq_c = phase_sq_times(dev, sq_gpu, wavs, sq_path, smi)

    sq_train_err = phase_sq_train_kernels(dev)
    sq_launches_t, sq_rows, sq_trainer = phase_sq_train(dev, corpus)
    sq_train_t = phase_sq_train_times(dev, sq_rows, sq_trainer, smi)

    flash_worst = phase_flash_kernels(dev)
    static_runs, static_launches = {}, {}
    for family in ("conformer", "squeezeformer"):
        s_gpu, long, static_launches[family] = phase_static_flagship(
            dev, family)
        static_runs[family] = (s_gpu, long)
    flash_t = phase_flash_times(dev, smi, static_runs)

    emit({"phase": "total", "seconds": time.perf_counter() - t_start})
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
        "bound_by": c_bound["bound_by"], "library_ms": None}, {
        "name": "fused_squeezeformer_layer", "route": "cuda",
        "source": "masr_tpu_torch/csrc/squeezeformer_layer.cu",
        "replaces": "masr_tpu/ops/pallas/squeezeformer_layer.py:166",
        "launches": sq_launches,
        "max_abs_err": max(sq_worst, sq_t["max_abs_err"]), "ms": sq_t["ms"],
        "plain_ms": sq_t["plain_ms"], "bound_ms": sq_t["bound_ms"],
        "bound_by": sq_t["bound_by"], "library_ms": None}, {
        "name": "fused_chunk_layer_sq", "route": "cuda",
        "source": "masr_tpu_torch/csrc/chunk_layer_sq.cu",
        "replaces": "masr_tpu/ops/pallas/chunk_layer_sq.py:181",
        "launches": sq_chunk_launches,
        "max_abs_err": max(sq_chunk_worst, sq_c["max_abs_err"]),
        "ms": sq_c["ms"], "plain_ms": sq_c["plain_ms"],
        "bound_ms": sq_c["bound_ms"], "bound_by": sq_c["bound_by"],
        "library_ms": None}, {
        "name": "fused_conformer_layer_train", "route": "cuda",
        "source": "masr_tpu_torch/csrc/conformer_layer_train.cu",
        "replaces": "masr_tpu/ops/pallas/conformer_layer_train.py:674",
        "launches": t_launches[0], "max_abs_err": train_err,
        "ms": t_layer["ms"], "plain_ms": t_layer["plain_ms"],
        "bound_ms": t_layer["bound_ms"], "bound_by": t_layer["bound_by"],
        "library_ms": None}, {
        "name": "ctc_loss", "route": "cuda",
        "source": "masr_tpu_torch/csrc/ctc_loss.cu",
        "replaces": "masr_tpu/ops/pallas/ctc_loss.py:158",
        "launches": t_launches[2], "max_abs_err": ctc_err,
        "ms": t_ctc["ms"], "plain_ms": t_ctc["plain_ms"],
        "bound_ms": t_ctc["bound_ms"], "bound_by": t_ctc["bound_by"],
        "library_ms": t_ctc["library_ms"]}, {
        "name": "fused_squeezeformer_layer_train", "route": "cuda",
        "source": "masr_tpu_torch/csrc/squeezeformer_layer_train.cu",
        "replaces": "masr_tpu/ops/pallas/squeezeformer_layer_train.py:608",
        "launches": sq_launches_t[0], "max_abs_err": sq_train_err,
        "ms": sq_train_t["ms"], "plain_ms": sq_train_t["plain_ms"],
        "bound_ms": sq_train_t["bound_ms"],
        "bound_by": sq_train_t["bound_by"], "library_ms": None}, {
        "name": "rel_pos_flash_attention", "route": "cuda",
        "source": "masr_tpu_torch/csrc/rel_pos_attention.cu",
        "replaces": "masr_tpu/ops/pallas/attention.py:122",
        "launches": static_launches["conformer"],
        "max_abs_err": max(flash_worst, flash_t["max_abs_err"]),
        "ms": flash_t["ms"], "plain_ms": flash_t["plain_ms"],
        "bound_ms": flash_t["bound_ms"], "bound_by": flash_t["bound_by"],
        "library_ms": flash_t["library_ms"]}]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
