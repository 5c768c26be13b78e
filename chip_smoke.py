#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (masr_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's offline and streaming recognition and its training (the
Conformer, the Squeezeformer, the Efficient-Conformer and DeepSpeech2;
training with host augmentation, the on-device frontend, the fused Adam
and binary manifests), the offline
recognition of static-chunk models, the decoders beyond greedy, export,
eval, long audio and the server, the user tools and the GUI's controller,
through their public entry points (MASRPredictor.predict_batch,
MASRPredictor.predict_stream, predict_long, BatchStreamSession,
MASRTrainer.train and .export, the export_model and eval CLIs, ASRServer,
the main() of masr_tpu_torch/tools/, StreamingRecognizer)
and holds every hand-written kernel
of those paths against its plain PyTorch twin. Phases, one JSON line each:

  1. build          compile the eight CUDA sources of the repo (nvcc, sm_90a),
                    one process per source, all started together, and the
                    native beam search (g++) beside them
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
                    4000, B=8, 2 epochs of 8 steps, then a second trainer
                    resumes from last_model for a third; every step must
                    launch the training-layer kernel 12x forward and 12x
                    backward and the CTC kernel once each way; the loss per
                    label token and the test loss fall; the first step at
                    dropout 0 against the CPU (loss and a sample of grads)
 13. train_times    training layer forward and backward and CTC forward +
                    backward, kernel vs plain (and F.ctc_loss for CTC), CUDA
                    events; the CTC kernel's forward and backward apart,
                    with each CUDA kernel's device time and the SM clock
                    beside them; train-step wall times, audio seconds trained
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
                    corpus (build/smoke/sq_train): 2 epochs of 8 steps at
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
                    a torch.profiler breakdown of one step
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
 25. decoders_bundle  the example bundle with ctc_beam_search (beam 300 of
                    configs/conformer.yml; with and without a character
                    bigram ARPA of the bundle's training sentences, written
                    to build/smoke/decoders/), attention_rescoring (the
                    n-best 10 of a beam of 30) and
                    ctc_beam_search_device (beam 10; with and without the
                    bigram's dense table): predict and predict_stream (0.2 s
                    pieces) on the card == on the CPU, >= 2 of 3 held-out
                    sentences exact (attention_rescoring reported only:
                    this bundle's attention decoder prefers shorter
                    hypotheses, in masr_tpu too), the native engine, 2
                    layer launches per encode and per window
 26. decoders_flagship  the flagship with configs/conformer.yml's attention
                    decoder (3 + 3 blocks, reverse_weight 0.3; encoder and
                    CTC head phase 3's bits): predict_batch of the 8
                    utterances with each decoder, 12 layer launches per
                    encode; texts == the CPU decoders on the card's probs;
                    rescore_hyps card vs CPU on the same rows and
                    hypotheses within 1e-4 + 1e-6 x |score| (a score sums
                    ~60 log-probs, |score| up to ~500); the device beam
                    (beam 10) with and without a dense bigram: texts == the
                    CPU's, scores within 1e-4; the Squeezeformer flagship
                    and the static-chunk Conformer with attention_rescoring:
                    12 row-6 / row-5 launches per encode
 27. decoders_stream  two-pass predict_stream (attention rescoring at the
                    end over every window's encoder rows, 12 chunk launches
                    a window) == the CPU decoders replayed on the card's
                    window probs and rows; the Squeezeformer's two-pass
                    stream, 12 row-8 launches a window; a 32-slot engine with
                    ctc_beam_search_device: texts == each stream's own
                    predict_stream, 12 chunk launches per dispatch, a
                    closed slot reopens fresh
 28. decoders_eval  phase 12's checkpoint evaluated by MASRTrainer with
                    attention_rescoring and ctc_beam_search_device: per
                    batch 12 training-layer and 1 CTC forward launches and
                    12 full-context layer launches; texts == the CPU
                    decoders on the card's outputs; phase 20's layer_norm
                    Squeezeformer with ctc_beam_search_device (rows 7, 4,
                    6: 12 + 1 + 12 per batch)
 29. decoder_times  the native beam 300 on the shortest and the longest
                    utterance, the Python engine on the shortest, the thread
                    pool over 8; the device beam at B=8 (wall, and the
                    profiler's device time and kernel launches over its
                    first 60 frames), the engine's beam step per dispatch;
                    one rescore at N=10; the two-pass end-of-stream latency
 30. export         phase 12's Conformer checkpoint through MASRTrainer.export
                    (f32) and `masr_tpu_torch.export_model.main` (bf16, int8;
                    the config as a YAML file), phase 20's BatchNorm
                    Squeezeformer checkpoint (batch_stats) through
                    MASRTrainer.export; each bundle loaded by MASRPredictor on
                    the card: probs of the 8 utterances vs the trained
                    model's (1e-4), the quantized bundles within 5e-3
                    (bf16) and 1e-2 (int8) of the f32 one with its greedy
                    texts, 12 row-1 / row-6 launches per encode; phase 3's
                    seeded flagship, whose frames decode to text, written
                    as bf16 and int8: probs within 0.05 of f32, the texts'
                    error rate against f32's reported; the bundles' sizes
 31. eval_cli       `masr_tpu_torch.eval.main` on phase 12's corpus and
                    checkpoint: (error rate, loss) == MASRTrainer.evaluate in
                    process; per eval batch 12 row-3 and 1 row-4 forward
                    launches and 12 row-1
 32. long_audio     predict_long of an ~70 s recording (the example corpus's
                    sentences and speech-like stretches between silences) on
                    the example bundle and phase 3's flagship: the silero
                    model ran, segments and text == the CPU port's, row-1
                    launches per group of 16 segments; the VAD (host) timed
                    apart from the encodes
 33. server         ASRServer on 127.0.0.1 (free ports, the websockets
                    package over real sockets) over the example bundle,
                    phase 30's f32 flagship, phase 15's seeded Squeezeformer
                    and phase 23's static-chunk bundle: first the latency
                    sample on a server that has answered nothing yet
                    (SERVER_LOAD /recognition requests over the 8 utterances
                    and SERVER_LOAD_LONG 20 s long-audio requests, one at a
                    time, every one a success with the predictor's text;
                    p50 / p90 on the client's clock and by /stats), then
                    /recognition (raw and multipart),
                    /recognition_long_audio, 400, 404, /stats; every text ==
                    the predictor's in process, use_pun + is_itn == ITN of
                    the punctuated text; each of the 8 utterances streamed
                    over WebSocket == predict_stream, a second connection
                    refused as busy; max_streams=4 (greedy, and
                    ctc_beam_search_device) over phase 7's seeded flagship,
                    the 8 utterances in two rounds of 4 concurrent streams
                    == the engine in process (== predict_stream), a fifth
                    refused; launches per request from the server's threads
                    (12 row-1 per /recognition, 12 row-6 and 12 row-8 per
                    request and window on the Squeezeformer, 12 row-5 on
                    the static bundle, 12 row-2 per window or dispatch);
                    the WebSocket reply latency with its sample size, the
                    card's name and power limit

 34. eff_kernels    rows 1 and 3 at the Efficient-Conformer tail's shape
                    (configs/efficient_conformer.yml widths, conv kernel 7
                    after the stride): B=8, T'=150 with every length halved
                    rounding up, causal and not; row 3 with the [::2, ::2]
                    view of a dynamic-chunk mask, dropout 0 and 0.1 / 0.1;
                    against the plain twins, CUDA-event times, f32 and
                    3xTF32 bounds
 35. eff_flagship   the 12-block Efficient-Conformer (grouped layers 0-3,
                    stride layer 3, seeded): predict_batch of the 8
                    utterances, card vs CPU probs, 8 row-1 launches (the
                    tail) per encode and no row-2; eff_static: the same
                    model with static_chunk_size 16 (streaming off): warmup
                    and predict_batch launch row 5 8 times per encode and
                    row 1 none, probs card vs CPU
 36. eff_stream     its predict_stream (both frontends, whole and in 0.2 s
                    pieces, card vs CPU) and an 8-stream engine (texts ==
                    predict_stream's, 4 slots on the CPU), eager chunk steps
                    (no chunk-layer launch, as masr_tpu streams this
                    family); eff_stream_times: window latency p50 / p90
 37. eff_train      MASRTrainer on phase 12's corpus: 8 steps at B=8, each
                    8 + 8 row-3 and 1 + 1 row-4 launches, the loss per label
                    token falling; the first step at dropout 0 card vs CPU
                    (the hybrid loss, and the encoder's grads of the CTC
                    loss alone); step walls and the card's idle share (1
                    profiled step)
 38. eff_export     the trained checkpoint through MASRTrainer.export: the
                    f32 bundle's probs == the model's, 8 row-1 launches per
                    encode; the eval CLI's batch: 8 row-3 and 1 row-4
                    forward and 8 row-1 launches, (error, loss) == evaluate
                    in process
 39. ds2_flagship   DeepSpeech2 at configs/deepspeech2.yml's widths (5 x
                    LSTM 1024, forward, fbank 80, V=4000, seeded, written by
                    the port's exporter), its bidirectional twin (streaming
                    off) and a GRU twin (both 2 layers of 1024, to keep
                    the script's time): predict_batch of the 8
                    utterances,
                    probs card vs CPU (PROBS_ATOL, no argmax flip past the
                    margin), no launch of any of the eight kernels (the
                    recurrence is cuDNN's, TF32 off); the wall time
 40. ds2_stream     its predict_stream (both frontends, whole and in 0.2 s
                    pieces, card vs CPU) and an 8-stream engine (texts ==
                    predict_stream's, 4 slots on the CPU), no kernel launch;
                    ds2_stream_times: window latency p50 / p90 at B=1
 41. ds2_train      MASRTrainer on phase 12's corpus with the DS2 config's
                    widths: 8 steps at B=8, each 1 + 1 row-4 launches and
                    no other row, the loss per label token falling; the
                    first step card vs CPU (the loss and every grad); step
                    walls, audio s/s, the card's idle share over 1 profiled
                    step; the f32 export (probs == the model's) and the
                    eval CLI (1 row-4 forward per batch)
 42. train_aug      the flagship Conformer trained 4 steps (every other
                    utterance of phase 12's corpus) with
                    configs/augmentation.json, its noise manifest pointed at
                    synthetic noise beside the corpus: 12 + 12 row-3 and 1 +
                    1 row-4 launches per step, finite losses, the step wall
                    median beside phase 12's and the loader's wait
 43. train_device_frontend  the same with on_device_frontend, the fused Adam
                    and binary manifests: device fbank at dither 0 vs the
                    host fbank (1e-3), one fused Adam update vs the unfused
                    one on the card (1e-6), the same launches per step, the
                    step wall median
 44. bf16_kernels   rows 1, 2 and 5 in their bf16 modes (masr_tpu's compute
                    dtype bf16) vs their bf16 twins at flagship width, the
                    shapes of phases 2, 6 and 22 (inactive slots' bf16
                    caches bitwise unchanged; an utterance alone gives its
                    batch slice's bits): max abs err <= 8 bf16 roundings
                    (2^-8) of the largest output, mean <= one; each timed
                    (CUDA events) beside its f32 kernel, its bf16 twin and
                    the library (torch.matmul bf16 of the layer's products;
                    SDPA bf16 for row 5), with its bf16 bound (989 TFLOP/s
                    or 3.35 TB/s); row 5's bf16 kernel (csrc/
                    flash_wgmma.cuh) also over FLASH_SWEEP_T beside SDPA
                    bf16; the subsampling's bf16 product
                    (serving_product, K 4864) vs its twin at 32 windows, one
                    and 8 utterances, each window's bits alone == its rows
                    of the batch, timed beside torch.matmul bf16
 45. bf16_offline   phase 3's flagship read by InferencePredictor(dtype=
                    bf16): predict of the 8 utterances launches row 1's bf16
                    mode 12 times, the products (every bf16 Linear's,
                    models/layers.py) 14 times and nothing else; the
                    card's bf16 probs
                    stray from f32 at most twice as far as the CPU's bf16
                    twin route, no argmax flip past that margin; walls
                    beside f32; the example bundle's held-out sentences at
                    bf16 (>= 2 of 3), against f32
 46. bf16_stream    the bf16 predictor under predict_stream (12 row-2 bf16
                    launches and 14 products a window; fused frontend whole ==
                    pieces) and a 32-stream BatchStreamSession (bf16 slot
                    state, 12 bf16 launches and 2 products a dispatch, texts
                    == the single streams', the margin rule below; the
                    example bundle's 8 engine streams == its single
                    streams); window latency, tick
 47. bf16_static    phase 23's static-chunk flagship at bf16: encodes of the
                    8 and of the 4 long utterances launch row 5's bf16 mode
                    12 times, the products 134 times and row 1 never; probs as
                    phase 45's
 48. bf16_sq_kernels rows 6 and 8 in their bf16 modes vs their bf16 twins at
                    the shapes of phase 14 (row 6: B=4 ragged, T' 150 and
                    299, both conv norms, an utterance alone == its batch
                    slice; row 8: B=32 and 1 at full and half rate, n_sub 2,
                    inactive slots' bf16 caches bitwise unchanged, every
                    half-rate row's two copies equal, a slot alone == its
                    batch slice), the rule of phase 44; each timed beside
                    its f32 kernel, its bf16 twin and torch.matmul bf16 of
                    its products, with its bf16 bound
 49. bf16_sq        phase 15's Squeezeformer flagship read by
                    InferencePredictor(dtype=bf16): predict launches row
                    6's bf16 mode 12
                    times (no f32 launch), probs as phase 45's;
                    predict_stream (12 row-8 bf16 launches a window) and a
                    32-stream engine (12 a dispatch, bf16 slot state, texts
                    == the single streams' by the margin rule below)
 50. bf16_eff       the Efficient-Conformer flagship at bf16 the same way:
                    predict launches row 1's bf16 mode 8 times (its tail),
                    its streaming windows and engine eager (no kernel)
 51. bf16_ds2       DeepSpeech2 at bf16: the bidirectional twin's (phase
                    39's, 2 layers) predict and the forward one's
                    predict_stream and
                    32-stream engine (cuDNN's bf16 recurrence, no kernel)
 52. train_kernels_bf16  rows 3 and 7 in their bf16 modes (masr_tpu's
                    enable_amp) vs their bf16 twins at the shapes of phases
                    11 and 19 (B=8, T'=299; row 7 also at half rate,
                    T'=150), dropout 0 and 0.1 / 0.1: the output and every
                    grad within 8 roundings (max) and one (mean) of its own
                    magnitude; forward + backward timed beside the f32
                    kernel and the bf16 twin, with the bf16 bound; one
                    forward + backward profiled: each kernel's device
                    time, the products (tw_gemm_kernel) apart, the
                    launches, saved and scratch bytes, torch.matmul bf16
                    of the layer's product shapes (a yardstick)
 53. train_bf16     the flagship Conformer through MASRTrainer with
                    train_conf.enable_amp on half of phase 12's corpus: 16
                    steps at B=8 (8, then 8 in a trainer that resumes from
                    last_model), each 12 + 12 bf16 row-3 launches and 1 + 1
                    row-4 (f32); the loss per label token falls; the first
                    step's CTC loss and sampled encoder grads, card bf16 vs
                    CPU f32, within twice the CPU bf16 route's distance;
                    the f32 export at bf16 == the trained model's probs;
                    step walls by loader_items beside phase 12's f32 run
 54. sq_train_bf16  the same for the layer_norm Squeezeformer (phase 20's
                    config): 8 steps (4, then 4 resumed), 12 + 12 bf16 row-7
                    launches a step
 55. eff_train_kernels_bf16  row 3's bf16 mode at the Efficient-Conformer
                    tail's shape (phase 34's: B=8, T'=150, K=7, the chunk
                    mask's [::2, ::2] view, lengths halved rounding up),
                    causal and not, dropout 0 and 0.1 / 0.1, vs its bf16
                    twin by phase 52's rule; timed beside the f32 kernel
 56. sq_bn_train_bf16  phase 54 for the BatchNorm Squeezeformer
                    (configs/squeezeformer.yml's default, phase 20's
                    BatchNorm run): eager bf16 layers, 0 row-7 launches and
                    1 + 1 row-4 a step; every kernel the validation passes
                    launch is recorded (run_launches); the first step over
                    three draws whose inputs differ by an f32 rounding, the
                    grads' error pooled (first_step_bf16 says why)
 57. eff_train_bf16 the same for the Efficient-Conformer (phase 37's
                    config): its tail 8 + 8 bf16 row-3 launches a step
 58. ds2_train_bf16 the same for DeepSpeech2 (phase 41's config, 5 x LSTM
                    1024): cuDNN's bf16 LSTM under autograd, 0 row-3 and
                    1 + 1 row-4 launches a step
 59. pipeline       the user's pipeline without JAX, on the card, in a
                    subprocess that blocks jax, jaxlib, flax and masr_tpu
                    from import: `python -m masr_tpu_torch.create_data`
                    (and --is_merge_audio True on a copy) on annotations of
                    18 of phase 12's utterances, `.extract_features`, the
                    train CLI (the flagship, 2 steps at B=8 on the .feature
                    manifests), `.export_model`, `.infer_path` short, long
                    and real-time demo on the trained flagship (short
                    and the demo also on the example bundle, whose text
                    is not empty); each
                    step's outputs checked, rows 1-4's launches per CLI,
                    and infer_path's texts == the in-process predictor's
                    on the card
 60. convert_checkpoint  `masr_tpu_torch.tools.convert_masr_checkpoint` on
                    an upstream model.pt of the flagship (phase 12's
                    config, seeded weights, with `.concat_linear.`,
                    num_batches_tracked and global CMVN entries): the
                    bundle's probs of 4 utterances on the card == the state
                    dict's model's, bit for bit; 12 row-1 launches per
                    encode; probs and argmax against the CPU's (phase 3's
                    rule), the texts equal to the CPU's counted
 61. avg_checkpoints  `masr_tpu_torch.tools.avg_checkpoints` over phase 12's
                    epochs 1-3: every floating tensor == torch.stack(...)
                    .mean(0), the rest epoch 3's; the export_model CLI on
                    the average, whose bundle predicts (12 row-1 launches,
                    probs == the averaged model's); MASRTrainer.train
                    (resume_model=avg) takes one step
 62. tune           `masr_tpu_torch.tools.tune`, a 2x2 grid over 4 test
                    utterances with a character bigram ARPA, on phase 60's
                    bundle: the host grid, then --use_device (the beam on
                    the card); 12 row-1 launches per cached utterance; each
                    point's error == the CPU's decode of the card's cached
                    probs; the BEST line names a grid pair
 63. soak_stream    `masr_tpu_torch.tools.soak_stream`, 3 minutes of 2
                    streams on the flagship stream bundle with a 512-row
                    position table (its horizon crossed in minute 1): sane
                    partials, 12 row-2 launches per dispatch, device memory
                    after each minute flat after the first (1 MiB bound)
 64. gui_stream     the GUI's StreamingRecognizer (infer/gui_app.py) over
                    the card's predictor, fed one corpus utterance by
                    FileSource: its last partial == the same calls in one
                    thread == predict_stream whole (same_text's rule); 12
                    row-2 launches per window; on_log only the save
                    message; the recording's PCM == the input's

 65. subsampling_kernels  configs/conformer.yml's widths with input_layer
                    conv2d8, conv2d6 and linear in turn (the kernels' layer
                    shape: layer_route "kernel", only T' changes): a
                    predict_batch encode of the 8 utterances (12 row-1
                    launches), 4 chunk dispatches at B=32 through
                    forward_chunk_batched (12 row-2 launches each), one
                    train step at B=8, dropout 0 (12 + 12 row-3 and 1 + 1
                    row-4 launches); each path against itself through the
                    plain twins on the card (probs PROBS_ATOL, loss rel
                    1e-5, grads 10 x GRAD_RTOL of their max), rows 1 and 3
                    against their twins at layer 0's real inputs
                    (KERNEL_ATOL, GRAD_RTOL), rows 1-4 timed at the new
                    shapes, the train step's peak device memory above what
                    was live when it began
 66. eager_routes   the eager route on the card: configs/conformer.yml's
                    widths with activation relu, a BatchNorm conv module and
                    post-norm layers, and configs/squeezeformer.yml's
                    pre-norm: layer_route "eager"; predict_batch, a 4-window
                    chunk chain at B=8 and a train step launch none of rows
                    1, 2, 3, 6, 7, 8 (row 5, the flash attention of an
                    eager rel-pos layer, may), the step row 4 once each way;
                    encoder rows and chunk outputs card vs CPU (EAGER_ATOL),
                    probs (PROBS_ATOL, argmax past the margin), the step's
                    loss (rel 1e-4) and grads (1e-2 of their max)
 67. small_gaps     mfcc_torch and argmax_decode on the card against the
                    host's mfcc_numpy (phase 43's 1e-3 a log-mel bin,
                    through the DCT) and greedy_decoder_batch; a
                    2-block flagship MASRTrainer with profile_batches [1, 2]
                    stopped after 3 batches writes a trace holding the
                    card's kernels

 68. parallel_train data and tensor parallelism (masr_tpu_torch/parallel/)
                    at flagship widths on 16 of phase 12's utterances,
                    dropout 0: (a) dp = 2 and (b) dp = 1 x tp = 2, two
                    ranks of this script (--parallel-rank) sharing the card
                    over gloo (NCCL refuses two ranks on one device), 2
                    Adam steps of 8 rows a rank against one process's 2
                    steps on the 16: loss rel 1e-5, every parameter 1e-5,
                    12 + 12 row-3 and 1 + 1 row-4 launches a rank and step,
                    (b)'s ruled Adam moments half their tensor; (c)
                    MASRTrainer under a NCCL group of one (WORLD_SIZE=1,
                    RANK=0, LOCAL_RANK=0), 2 steps, the same launches; (d)
                    row 4 on B=8, T'=299 with two rows of more labels than
                    frames (optax's semantics: NLL 1e5 + the paths' cost)
                    and on a forced alignment of 1100 labels (S = 2201)
                    over exactly the frames they need and a frame fewer,
                    against its twin (NLL rel 1e-5, the card's grad gate).
                    Prints each rank's step walls, the grad all-reduce's
                    seconds over gloo and its peak device memory

The kernels line counts each row's launches over every main path that
reaches it: rows 1-4 add phase 65's to those of phases 3, 8 and 12, and
rows 3-4 phase 68's trainer steps (c); row 5 phase 66's eager encodes to
phase 23's.

A text that differs between two runs fails only where the first differing
frame's top-2 margin exceeds 1e-3 (a near-tie that f32 sums in another
order may flip). Then the script's total seconds, the kernels line, the
card's name and power limit, and last {"ok": true, "device": {...}}. Any failed check raises: the script
exits non-zero and prints no result. It needs CUDA and the repository's
package beside it; it imports nothing of JAX.
"""
import asyncio
import contextlib
import json
import logging
import os
import shutil
import socket
import subprocess
import sys
import threading
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
# configs/conformer.yml decoder_conf and model_conf
FLAGSHIP_DECODER = dict(attention_heads=4, linear_units=1024, num_blocks=3,
                        r_num_blocks=3, dropout_rate=0.1,
                        positional_dropout_rate=0.1,
                        self_attention_dropout_rate=0.1,
                        src_attention_dropout_rate=0.1)
FLAGSHIP_MODEL_CONF = dict(ctc_weight=0.3, lsm_weight=0.1, reverse_weight=0.3,
                           length_normalized_loss=False)
# configs/efficient_conformer.yml encoder_conf (streaming: True → causal
# conv): kernels 15, then 7 after the stride layer 3; layers 4-11 (the
# plain tail) take the layer kernels
EFF_ENCODER = dict(output_size=256, attention_heads=4, linear_units=2048,
                   num_blocks=12, activation_type="swish",
                   cnn_module_kernel=15, cnn_module_norm="layer_norm",
                   dropout_rate=0.1, input_layer="conv2d",
                   normalize_before=True, pos_enc_layer_type="rel_pos",
                   attention_dropout_rate=0.1, positional_dropout_rate=0.1,
                   efficient_conf=dict(stride_layer_idx=[3], stride=[2],
                                       group_layer_idx=[0, 1, 2, 3],
                                       group_size=3, stride_kernel=True))
EFF_TAIL, EFF_TAIL_KERNEL = 8, 7
# per family: layers through a full-context layer kernel per encode, and
# through a chunk-layer kernel per streaming window (the Efficient-
# Conformer streams eagerly, as masr_tpu), and its phases' name prefix
LAYER_LAUNCHES = {"conformer": 12, "squeezeformer": 12,
                  "efficient_conformer": EFF_TAIL, "deepspeech2": 0}
CHUNK_LAUNCHES = {"conformer": 12, "squeezeformer": 12,
                  "efficient_conformer": 0, "deepspeech2": 0}
PHASE_PREFIX = {"conformer": "", "squeezeformer": "sq_",
                "efficient_conformer": "eff_", "deepspeech2": "ds2_"}
# configs/deepspeech2.yml encoder_conf (streaming: True → forward LSTMs)
DS2_ENCODER = dict(num_rnn_layers=5, rnn_size=1024, use_gru=False)
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


T_START = time.perf_counter()


def emit(obj):
    """One JSON line; a phase's line also carries at_s, the seconds since
    the script started."""
    if "phase" in obj:
        obj = dict(obj, at_s=time.perf_counter() - T_START)
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


def write_flagship_bundle(path, use_model="conformer", static_chunk=0,
                          decoder=False, encoder=None):
    """A flagship bundle (the Conformer's, or with use_model="squeezeformer"
    the Squeezeformer's of configs/squeezeformer.yml, BatchNorm statistics
    in batch_stats) with weights drawn from seed 0, written the way
    masr_tpu's exporter writes one (flax msgpack), CMVN from the example
    bundle (same fbank frontend); use_model="efficient_conformer" gives
    the Efficient-Conformer of configs/efficient_conformer.yml; `encoder`
    updates the family's encoder_conf. With static_chunk, a static-chunk
    model: encoder_conf use_dynamic_chunk
    false and that static_chunk_size; the Squeezeformer and the
    Efficient-Conformer then have streaming off (with it on, masr_tpu's and
    the port's models force a dynamic chunk). With decoder, the
    Conformer gets configs/conformer.yml's attention decoder (3 + 3 blocks)
    and model_conf: every other tensor is the one the bundle has without
    it, bit for bit (seeded_state_dict draws them from seed 0 on the model
    without this decoder), the decoder's are drawn from seed 1."""
    from masr_tpu_torch.infer import flax_msgpack
    from masr_tpu_torch.models.registry import build_model
    from masr_tpu_torch.models.weights import (seeded_state_dict,
                                               to_flax_variables)
    with open(os.path.join(TINY_BUNDLE, "inference.json"),
              encoding="utf-8") as f:
        tiny = json.load(f)
    encoder_conf, decoder_conf = {
        "conformer": (FLAGSHIP_ENCODER, {}),
        "squeezeformer": (SQ_ENCODER, SQ_DECODER),
        "efficient_conformer": (EFF_ENCODER, {})}[use_model]
    encoder_conf = dict(encoder_conf, **(encoder or {}))
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
    model_conf = {}
    if decoder:
        decoder_conf, model_conf = FLAGSHIP_DECODER, FLAGSHIP_MODEL_CONF
        full = build_model(use_model, 80, VOCAB, streaming=streaming,
                           encoder_conf=encoder_conf,
                           decoder_conf=decoder_conf, model_conf=model_conf)
        drawn = seeded_state_dict(full, seed=1)
        state = {k: drawn[k] if k.startswith("decoder.") else state[k]
                 for k in full.state_dict()}
    variables = to_flax_variables(state)
    meta = {"framework": "masr_tpu", "use_model": use_model,
            "streaming": streaming, "input_dim": 80, "vocab_size": VOCAB,
            "mean": tiny["mean"], "istd": tiny["istd"],
            "encoder_conf": encoder_conf, "decoder_conf": decoder_conf,
            "model_conf": model_conf, "preprocess_conf": PREPROCESS,
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


def synthetic_texts(vocab):
    """The texts of synthetic_utterances and their speakers."""
    rs = np.random.RandomState(1)
    return [("".join(vocab[j] for j in rs.randint(2, len(vocab) - 1, n)), i)
            for i, n in enumerate(np.linspace(10, 59, 8).astype(int))]


def synthetic_utterances(vocab):
    """8 utterances of 10..59 characters: 2.1 s to 11.9 s of audio."""
    from masr_tpu_torch.audio.synth_tts import SyntheticTTS
    tts = SyntheticTTS(sample_rate=16000)
    return [tts.render(text, spk_id=spk)
            for text, spk in synthetic_texts(vocab)]


def layer_kernel(family):
    """The full-context layer kernel's wrapper (its .launches counts); the
    Efficient-Conformer's tail runs the Conformer's (DeepSpeech2 runs
    none: its counts read the Conformer's, which must stay 0)."""
    if family in ("conformer", "efficient_conformer", "deepspeech2"):
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
    if family in ("conformer", "efficient_conformer", "deepspeech2"):
        from masr_tpu_torch.ops.cuda.chunk_layer import \
            fused_chunk_layer as fn
    else:
        from masr_tpu_torch.ops.cuda.chunk_layer_sq import \
            fused_chunk_layer_sq as fn
    return fn


def phase_flagship(dev, family="conformer"):
    """predict_batch of the 8 utterances on the family's flagship: card vs
    CPU probs, launches per encode (phase "flagship" / "sq_flagship" /
    "eff_flagship")."""
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
    n_layers = LAYER_LAUNCHES[family]
    check(launches == n_layers, f"{family} kernel launches {launches} == "
          f"{n_layers} layers x 1 encoder call")
    check(flash_kernel().launches == 0, "no flash attention launch without "
          "a static chunk")
    cpu = MASRPredictor(model_dir=path, device="cpu", warmup=False)
    err, compared, t_out = probs_card_vs_cpu(gpu, cpu, wavs)
    cpu_texts = cpu.predict_batch(wavs)
    emit({"phase": PHASE_PREFIX[family] + "flagship",
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


def cuda_ms(fn, iters=20, warm=3):
    for _ in range(warm):
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
    ms = sum(device_kernels(fn, n).values())
    return ms if ms > 0 else "not measured"


def device_kernels(fn, n=10):
    """Device time per call (ms) of each CUDA kernel fn launches, by the
    kernel's name without namespace and parameters (torch.profiler over n
    calls)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        t = getattr(ev, "self_device_time_total", None)
        t = getattr(ev, "self_cuda_time_total", 0.0) if t is None else t
        if t > 0:
            name = ev.key.replace("(anonymous namespace)::", "")
            name = name.split("(")[0].replace("void ", "")
            out[name] = out.get(name, 0.0) + t / 1e3 / n
    return out


def sm_clock():
    """nvidia-smi's SM clock and power draw, one reading."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def alternate(kernel, plain):
    """CUDA-event times in the order plain, kernel, kernel, plain (the
    plain twin, 10-400 x slower, over 5 calls after 1)."""
    runs = {"plain": [cuda_ms(plain, 5, 1)], "kernel": [cuda_ms(kernel)]}
    runs["kernel"].append(cuda_ms(kernel))
    runs["plain"].append(cuda_ms(plain, 5, 1))
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


def window_rows(starts, L):
    """Distinct rows that windows of L rows at `starts` read from one
    position table (the table route: the slots' windows overlap)."""
    rows = set()
    for s in starts.tolist():
        rows.update(range(s, s + L))
    return len(rows)


def chunk_bound(layer, clens, active, c, C, rep=1, pos_rows=None):
    """One chunk-layer call (n_sub = 1) over B slots at the layer's rate:
    matmuls over B*c rows (pw1 over the k-1+c conv-input rows), attention
    of each slot over its cache_len valid cache keys and the c chunk keys;
    bytes: packed weights, x in and out, the valid cache rows read, the
    fresh rows (rep copies each) and cnn caches of active slots written,
    the position rows read (pos_rows: the distinct rows of the table route,
    window_rows; else one window of C + c per slot), cnn caches read."""
    D, F, K = _widths(layer)
    B = len(clens)
    if pos_rows is None:
        pos_rows = B * (C + c)
    M, W = B * c, K - 1 + c
    flops = (8 * M * D * F + 8 * M * D * D + 4 * B * W * D * D
             + 2 * M * D * D + 2 * M * D * K
             + sum(6 * D * c * (n + c) for n in clens))
    n_act = sum(bool(a) for a in active)
    nbytes = _weight_bytes(layer) + 4 * (
        2 * M * D                                 # x in, out
        + sum(clens) * 2 * D                      # valid [K|V] cache rows
        + n_act * min(c, C) * 2 * D * rep         # fresh rows written
        + pos_rows * D                            # position rows
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
    0.2 s pieces (phase "stream" / "sq_stream" / "eff_stream")."""
    from masr_tpu_torch.infer.predictor import MASRPredictor
    n_layers = CHUNK_LAUNCHES[family]
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
    emit({"phase": PHASE_PREFIX[family] + "stream",
          "seconds_audio": round(len(wav) / 16000, 3), "runs": rows})
    return launches


def phase_engine(dev, path, wavs, family="conformer",
                 n_streams=ENGINE_STREAMS):
    """An n_streams BatchStreamSession on the card vs predict_stream and a
    4-slot CPU engine; for an encoder with position tables, a tiny table
    whose horizon the streams cross (phase "engine" / "sq_engine" /
    "eff_engine")."""
    from masr_tpu_torch.infer.batch_stream import BatchStreamSession
    from masr_tpu_torch.infer.predictor import MASRPredictor
    n_layers = CHUNK_LAUNCHES[family]
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

    streams = [wavs[k % len(wavs)] for k in range(n_streams)]
    # the main path: counts read around the engine run alone
    reset_launches()
    t0 = time.perf_counter()
    got, routes = run(gpu, streams, n_streams)
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
    if getattr(gpu.predictor.model.encoder, "position_tables", False):
        tiny, tiny_routes = run(gpu, wavs, len(wavs),
                                pos_table_len=CACHE + CHUNK + 4 * CHUNK)
        check(any(e for _, e in tiny_routes) and not all(
            e for _, e in tiny_routes), "both position routes dispatched")
        tiny_margins = [same_text(tiny[k], got[k], f"horizon stream {k}")
                        for k in range(len(wavs))]
    emit({"phase": PHASE_PREFIX[family] + "engine",
          "streams": n_streams,
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


def engine_tick(dev, path, wavs, B, dtype=None):
    """Engine tick wall at B active slots, each given one window (0.64 s)
    per feed_many, 13 ticks: tick and dispatch times, median of ticks 4-13,
    and the real-time factor B x 0.64 s / tick (dtype bf16: the bf16
    predictor's engine)."""
    from masr_tpu_torch.infer.batch_stream import BatchStreamSession
    from masr_tpu_torch.infer.predictor import MASRPredictor
    need = FIRST_WINDOW_SAMPLES + 12 * STRIDE_SAMPLES
    long_wavs = [np.tile(w, -(-need // len(w)))[:need] for w in wavs]
    gpu = (bf16_predictor(path, dev, fused_frontend=False) if dtype
           else MASRPredictor(model_dir=path, device=dev,
                              fused_frontend=False))
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


def window_latency(dev, path, wavs, dtype=None):
    """predict_stream window latency at B = 1, fused frontend, 12 windows
    of 0.64 s after the first (dtype bf16: the bf16 predictor's)."""
    from masr_tpu_torch.infer.predictor import MASRPredictor
    need = FIRST_WINDOW_SAMPLES + 12 * STRIDE_SAMPLES
    wav = np.tile(wavs[7], -(-need // len(wavs[7])))[:need]
    one = (bf16_predictor(path, dev) if dtype
           else MASRPredictor(model_dir=path, device=dev))
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
    bound = chunk_bound(layer, clens, active, CHUNK, CACHE,
                        pos_rows=window_rows(args[2], CACHE + CHUNK))
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
TRAIN_STEPS_PER_EPOCH, TRAIN_EPOCHS = 8, 2
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
    """The family's training-layer kernel wrapper (its launch counts); the
    Efficient-Conformer's tail runs the Conformer's."""
    if family in ("conformer", "efficient_conformer"):
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
    the kernel launches, loss, label tokens, audio seconds and the
    utterances the loader's threads read while the step ran → rows."""
    from masr_tpu_torch.data.dataset import MASRDataset
    from masr_tpu_torch.training import trainer as tr
    orig, orig_item = tr.train_step, MASRDataset.__getitem__

    last, items = [None], [0]

    def item(self, idx):
        out = orig_item(self, idx)
        items[0] += 1
        return out

    def step(state, batch, seed):
        torch.cuda.synchronize()
        before = train_launches(family)
        flash_before = flash_kernel().launches
        items_before = items[0]
        t0 = time.perf_counter()
        m = orig(state, batch, seed)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        # lengths are frames (100 a second), or samples for the on-device
        # frontend's waveform batches
        per_s = 16000.0 if batch["inputs"].dim() == 2 else 100.0
        rows.append({"s": t1 - t0, "loss": m["loss"],
                     "finite": m["finite"],
                     "wait_s": None if last[0] is None else t0 - last[0],
                     "tokens": float(batch["label_lens"].float().mean()),
                     "audio_s": float(batch["input_lens"].sum()) / per_s,
                     "launches": [a - b for a, b in
                                  zip(train_launches(family), before)],
                     "flash_launches": flash_kernel().launches
                     - flash_before,
                     "loader_items": items[0] - items_before})
        last[0] = t1
        return m

    tr.train_step, MASRDataset.__getitem__ = step, item
    try:
        yield rows
    finally:
        tr.train_step, MASRDataset.__getitem__ = orig, orig_item


def train_and_resume(config, corpus, root, family, step_launches):
    """The main path of a training phase: MASRTrainer(dict config,
    device=cuda).train for TRAIN_EPOCHS epochs of 8 steps, then a second
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
                    device="cuda").train(save_model_path=save,
                                         augment_conf_path=None)
        first_s = time.perf_counter() - t0
        resumed = MASRTrainer(config(corpus, root, TRAIN_EPOCHS + 1),
                              device="cuda")
        resumed.train(save_model_path=save, augment_conf_path=None)
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
                      for n, p in t.model.named_parameters()
                      if p.grad is not None},
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
    synthetic corpus: 2 epochs of 8 steps at B=8, then a resume for a third
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


# DeepSpeech2's step: cuDNN's recurrence (its products in cutlass / cuBLAS
# f32 SIMT GEMMs, TF32 off, with the CTC head's) and the CTC kernel
DS2_PROFILE_GROUPS = (
    ("products: cuDNN RNN and the CTC head (f32 SGEMM)",
     ("sgemm", "gemmSN", "xmma_gemm", "splitKreduce")),
    ("cuDNN RNN: cell elementwise", ("elemWiseRNNcell", "elementWise_bp",
                                     "elementWise_fp")),
    ("CTC kernel", ("ctc_",)))


def profile_train_steps(trainer, n=1, kernel_groups=PROFILE_GROUPS,
                        items_from=None):
    """torch.profiler over n train steps of `trainer` on the batch of the 8
    longest training utterances (of `items_from`'s training set, if given,
    unaugmented): device kernel time by group, device busy time against the
    steps' wall time, audio seconds trained per second."""
    from torch.profiler import ProfilerActivity, profile
    from masr_tpu_torch.data.collate import collate_fn
    from masr_tpu_torch.training import train_state as ts
    ds = (items_from or trainer)._setup_dataloader(True)[0]
    items = [ds[i] for i in range(len(ds) - len(TRAIN_LENS), len(ds))]
    batch = ts.batch_to(collate_fn(items, rng=np.random.RandomState(0)),
                        trainer.device)
    ts.train_step(trainer.state, batch, 0)
    torch.cuda.synchronize()
    updates = trainer.state.updates
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
        name = next((g for g, keys in kernel_groups
                     if any(k in ev.key for k in keys)),
                    "PyTorch kernels (subsampling, decoder, CTC head, "
                    "optimizer, copies)")
        groups[name] = groups.get(name, 0.0) + us / 1e3 / n
    busy = sum(groups.values())
    top.sort(key=lambda kv: -kv[1])
    return {"steps": n, "B": int(batch["inputs"].shape[0]),
            "T_in": int(batch["inputs"].shape[1]),
            "audio_s": float(batch["input_lens"].sum()) / 100.0,
            "optimizer_updates": trainer.state.updates - updates,
            "wall_ms_per_step": wall / n * 1e3,
            "audio_s_per_s": float(batch["input_lens"].sum()) / 100.0
            / (wall / n),
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
    steps, every step's, the audio seconds trained per second, and the
    medians of the steps during which the loader's threads read
    utterances and of those during which they read none."""
    steady = rows[3:]

    def median(busy):
        s = [r["s"] for r in rows if (r["loader_items"] > 0) == busy]
        return float(np.median(s)) if s else None

    return {"step_s_median": float(np.median([r["s"] for r in steady])),
            "step_s": [r["s"] for r in rows],
            "audio_s_per_s": sum(r["audio_s"] for r in steady) / sum(
                r["s"] for r in steady),
            "loader_items": [r["loader_items"] for r in rows],
            "step_s_median_loader_reading": median(True),
            "step_s_median_loader_done": median(False)}


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

    # the kernel's forward and backward apart: the forward with the grad
    # recorded (both chains), the backward by autograd.grad (nothing
    # accumulates), each with its kernels' device times
    xk = lg.clone().requires_grad_(True)
    w = torch.ones(lg.shape[0], device=dev)

    def ctc_fwd():
        return C.ctc_loss(xk, lens, labels, label_lens)

    nll_k = ctc_fwd()

    def ctc_bwd():
        return torch.autograd.grad(nll_k, xk, w, retain_graph=True)

    clock = [sm_clock()]
    ctc = {"plain": [cuda_ms(ctc_plain, 2, 1)],
           "kernel": [cuda_ms(ctc_kernel)]}
    ctc["kernel"].append(cuda_ms(ctc_kernel))
    ctc["plain"].append(cuda_ms(ctc_plain, 2, 1))
    ctc["library"] = [cuda_ms(ctc_library)]
    split = {"fwd_kernel_ms": cuda_ms(ctc_fwd),
             "bwd_kernel_ms": cuda_ms(ctc_bwd),
             "fwd_device_ms": device_kernels(ctc_fwd),
             "bwd_device_ms": device_kernels(ctc_bwd)}
    clock.append(sm_clock())
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
                  "fwd_bwd_library_ms": ctc["library"], **split,
                  "sm_clock_power": clock, **ctc_b},
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
    run's 12 updates (24 steps) so that the loss falls within the run."""
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
    corpus: 2 epochs of 8 steps at B=8 and a resumed third, every step
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
        bn.train(save_model_path=os.path.join(bn_root, "models"),
                 augment_conf_path=None)
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
    return launches, rows, resumed, bn_rows


def phase_sq_train_times(dev, rows, trainer, smi):
    """The Squeezeformer training layer forward and backward, kernel vs
    plain, at B=8, full rate (T'=299) and half rate (T'=150), dropout 0.1
    (CUDA events, plain, kernel, kernel, plain), with their bounds; the
    train-step wall times and audio seconds per second of sq_train; a
    torch.profiler breakdown of one step on the longest batch."""
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
        # the CPU's encode is the phase's cost: the long batch's two
        # shorter utterances hold the card to it, the 8 give their texts
        err, compared, t_out = probs_card_vs_cpu(
            gpu, cpu, batch if name == "batch" else batch[:2])
        cpu_texts = cpu.predict_batch(batch) if name == "batch" else None
        runs[name] = {"utterances": len(batch),
                      "seconds_audio": [round(len(w) / 16000, 3)
                                        for w in batch],
                      "T_out": t_out, "launches": got[0],
                      "probs_max_abs_err": err,
                      "argmax_frames_compared": compared,
                      "texts_equal_cpu": None if cpu_texts is None else sum(
                          a["text"] == b["text"]
                          for a, b in zip(texts, cpu_texts)),
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


# --------------------------------------------------------------------------- #
# Decoders beyond greedy: the host prefix beam search, attention rescoring
# and the device beam. They add no kernel; their encodes run the layer
# kernels, which each phase counts around its own path.
# --------------------------------------------------------------------------- #
# tools/head_to_head.py CHARS: the example bundle's characters
CORPUS_CHARS = ("你好天气真完我家业世界语音识别学习工作水火山石田土木金"
                "雨雪风云日月星光红绿蓝白黑大小多少上下左右")
# configs/conformer.yml ctc_beam_search_decoder_conf (its KenLM file is not
# in the repository: the flagship beams decode without an LM)
BEAM_CONF = dict(alpha=2.2, beta=4.3, beam_size=300, num_processes=10,
                 cutoff_prob=0.99, cutoff_top_n=40)
DEVICE_BEAM = dict(beam_size=10, cutoff_top_n=40)
# attention rescoring's n-best of 10 comes from a beam of 30 (beam 300 takes
# 0.2-1.9 s an utterance on the H100 machine's host, phase decoder_times)
RESCORE_NBEST, RESCORE_BEAM = 10, 30
PROFILED_FRAMES = 60      # the device beam's profiled run (its launches)
PYTHON_FRAMES = 16        # the Python engine's timed slice
SCORE_ATOL = 1e-4         # beam scores, card vs CPU
# a rescoring score sums the log-probs of up to ~60 tokens over 4000 words
# (|score| up to ~1000, where f32's spacing is 6.1e-5): the card's is held
# to 4 f32 epsilons of the CPU score, plus 1e-5 near zero
RESCORE_ULPS = 4 * float(np.finfo(np.float32).eps)
RESCORE_ATOL = 1e-5
BUNDLE_DECODERS = (("ctc_beam_search", False), ("ctc_beam_search", True),
                   ("attention_rescoring", False),
                   ("ctc_beam_search_device", False),
                   ("ctc_beam_search_device", True))


def corpus_sentences(n_train=240, n_test=24, seed=0):
    """tools/head_to_head.py make_corpus(240, 24): the example bundle's
    training sentences (3-6 characters, all distinct)."""
    rs = np.random.RandomState(seed)
    seen, sents = set(), []
    while len(sents) < n_train + n_test:
        n = rs.randint(3, 7)
        s = "".join(CORPUS_CHARS[i]
                    for i in rs.randint(0, len(CORPUS_CHARS), n))
        if s not in seen:
            seen.add(s)
            sents.append(s)
    return sents[:n_train]


def write_char_bigram_arpa(sentences, path, discount=0.5):
    """A character bigram ARPA LM of `sentences`: add-one unigrams (and
    <unk>), absolutely discounted bigrams, each history's backoff weight
    spreading its discounted mass over the unigrams of its unseen
    successors. → path."""
    from collections import Counter
    uni, bi = Counter(), Counter()
    for s in sentences:
        uni.update(s)
        bi.update(zip(s, s[1:]))
    chars = sorted(uni)
    total = sum(uni.values()) + len(chars) + 1
    p_uni = {c: (uni[c] + 1) / total for c in chars}
    seen = Counter()
    succ = {}
    for (a, b), n in bi.items():
        seen[a] += n
        succ.setdefault(a, []).append(b)
    p_bi = {(a, b): (n - discount) / seen[a] for (a, b), n in bi.items()}
    lines = ["\\data\\", f"ngram 1={len(chars) + 1}",
             f"ngram 2={len(p_bi)}", "", "\\1-grams:",
             f"{np.log10(1 / total):.6f}\t<unk>"]
    for c in chars:
        line = f"{np.log10(p_uni[c]):.6f}\t{c}"
        if c in succ:
            left = 1 - sum(p_bi[(c, b)] for b in succ[c])
            rest = 1 - sum(p_uni[b] for b in succ[c])
            line += f"\t{np.log10(left / rest):.6f}"
        lines.append(line)
    lines += ["", "\\2-grams:"]
    lines += [f"{np.log10(p):.6f}\t{a} {b}" for (a, b), p in
              sorted(p_bi.items())]
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        f.write("\n".join(lines + ["", "\\end\\", ""]))
    return path


def profiled_launches(fn):
    """One call of fn under torch.profiler (after a warm call) → (device
    ms of the CUDA kernels it ran, how many kernels it launched)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ms, launches = 0.0, 0
    for ev in prof.key_averages():
        t = getattr(ev, "self_device_time_total", None)
        t = getattr(ev, "self_cuda_time_total", 0.0) if t is None else t
        if t > 0:
            ms += t / 1e3
            launches += ev.count
    return ms, launches


def rescoring_beam(vocab):
    """The host beam of attention_rescoring's n-best, as the predictor
    builds it from decoder_configs("attention_rescoring")."""
    from masr_tpu_torch.decoders.beam_search import BeamSearchDecoder
    conf = decoder_configs("attention_rescoring")
    conf.pop("rescoring_nbest")
    return BeamSearchDecoder(vocab, **conf)


def decoder_configs(decoder, lm_path=None, alpha=None, beta=None):
    conf = dict(DEVICE_BEAM) if decoder == "ctc_beam_search_device" \
        else dict(BEAM_CONF)
    if decoder == "attention_rescoring":
        conf.update(beam_size=RESCORE_BEAM, rescoring_nbest=RESCORE_NBEST)
    if lm_path:
        conf["language_model_path"] = lm_path
    if alpha is not None:
        conf.update(alpha=alpha, beta=beta)
    return conf


def count_chunk_steps(pred):
    """Counts the chunk steps of a predictor: every predict_stream window
    goes through its encoder's forward_chunk_batched. → the list that gets
    one entry per step."""
    enc = pred.predictor.model.encoder
    steps, orig = [], enc.forward_chunk_batched

    def counted(*a, **k):
        steps.append(1)
        return orig(*a, **k)

    enc.forward_chunk_batched = counted
    return steps


def stream_text(pred, wav, piece=PIECE):
    """predict_stream in pieces → (the final text, the wall seconds of the
    call with is_end); the stream is reset after."""
    text, last = None, 0.0
    for i in range(0, len(wav), piece):
        end = i + piece >= len(wav)
        t0 = time.perf_counter()
        r = pred.predict_stream(wav[i:i + piece], is_end=end)
        if end:
            last = time.perf_counter() - t0
        text = r["text"] if r is not None else text
    pred.reset_stream()
    return text, last


def phase_decoders_bundle(dev):
    """The trained example bundle with every decoder beyond greedy, on the
    card and on the CPU: predict and predict_stream (0.2 s pieces) of the
    held-out sentences, the card's text equal to the CPU's, >= 2 of 3
    exact (but for attention_rescoring: this bundle's 2-block attention
    decoder prefers shorter hypotheses, in masr_tpu too, so its hits are
    reported); the host beams run the native engine; 2 layer-kernel
    launches per encode, 2 chunk launches per window."""
    from masr_tpu_torch.audio.synth_tts import SyntheticTTS
    from masr_tpu_torch.infer.predictor import MASRPredictor
    t_phase = time.perf_counter()
    root = os.path.join(WORK, "decoders")
    os.makedirs(root, exist_ok=True)
    lm = write_char_bigram_arpa(corpus_sentences(),
                                os.path.join(root, "corpus_bigram.arpa"))
    tts = SyntheticTTS(sample_rate=16000)
    wavs = [(text, tts.render(text, spk_id=spk)) for text, spk in HELD_OUT]
    rows = []
    for decoder, with_lm in BUNDLE_DECODERS:
        conf = decoder_configs(decoder, lm if with_lm else None)
        gpu = MASRPredictor(TINY_BUNDLE, decoder=decoder,
                            decoder_configs=conf, device=dev, warmup=False)
        cpu = MASRPredictor(TINY_BUNDLE, decoder=decoder,
                            decoder_configs=conf, device="cpu", warmup=False)
        what = f"{decoder}{' + LM' if with_lm else ''}"
        check(gpu.decoder == decoder, f"{what}: no fallback to greedy")
        engine = None
        if gpu.beam_search_decoder is not None:
            engine = gpu.beam_search_decoder.engine
            check(engine == "native", f"{what}: the native engine runs "
                  f"({engine})")
            check(with_lm == (gpu.beam_search_decoder._native_scorer
                              is not None), f"{what}: the LM is loaded")
        else:
            lm_table = gpu._device_beam_conf["lm_table"]
            check(with_lm == (lm_table is not None)
                  and (lm_table is None or lm_table.is_cuda),
                  f"{what}: the dense bigram on the card")
        n_layers = gpu.predictor.meta["encoder_conf"]["num_blocks"]
        steps = count_chunk_steps(gpu)
        got = {"predict": [], "predict_stream": []}
        for text, wav in wavs:
            # each main path: counts read around its own call
            reset_launches()
            r = gpu.predict(wav)["text"]
            check(layer_kernel("conformer").launches == n_layers,
                  f"{what}: {n_layers} layer launches per predict")
            check(r == cpu.predict(wav)["text"], f"{what} predict: card "
                  f"text {r!r} == CPU text")
            got["predict"].append(r)
            reset_launches()
            del steps[:]
            r, _ = stream_text(gpu, wav)
            check(steps and chunk_launches() == n_layers * len(steps),
                  f"{what}: {n_layers} chunk launches x {len(steps)} "
                  "windows")
            check(r == stream_text(cpu, wav)[0], f"{what} predict_stream: "
                  f"card text {r!r} == CPU text")
            got["predict_stream"].append(r)
        hits = {k: sum(t == want for t, (want, _) in zip(v, wavs))
                for k, v in got.items()}
        if decoder != "attention_rescoring":
            check(min(hits.values()) >= 2, f"{what}: held-out sentences "
                  f"decoded {hits} of 3")
        rows.append({"decoder": what, "engine": engine, "exact": hits,
                     **got})
    emit({"phase": "decoders_bundle", "of": len(wavs), "lm": lm,
          "runs": rows, "seconds": time.perf_counter() - t_phase})


def phase_decoders_flagship(dev, wavs, smi):
    """The flagship with configs/conformer.yml's attention decoder (3 + 3
    blocks; encoder and CTC head the bits of phase 3's bundle),
    predict_batch of the 8 utterances with each decoder on the card (12
    layer launches per encode; attention_rescoring decodes greedily there,
    as in masr_tpu, and rescores in predict of each utterance), against
    the CPU decoders run on the card's probs and encoder rows: the host
    beam (beam 300) and attention rescoring (its rescore_hyps within
    1e-5 + 4 f32 epsilons x |score| of the CPU's on the same rows and
    hypotheses), the device beam (beam 10) with and without a dense bigram
    (same texts, scores within 1e-4). The Squeezeformer flagship (row 6)
    and the static-chunk Conformer (row 5) rescore one utterance each. →
    what decoder_times needs."""
    from masr_tpu_torch.decoders.beam_search import BeamSearchDecoder
    from masr_tpu_torch.decoders.device_beam import decode_batch_device
    from masr_tpu_torch.decoders.greedy import greedy_decoder
    from masr_tpu_torch.infer.bundle import load_inference_bundle
    from masr_tpu_torch.infer.inference_model import InferencePredictor
    from masr_tpu_torch.infer.predictor import MASRPredictor
    t_phase = time.perf_counter()
    path = os.path.join(WORK, "conformer_decoder_bundle")
    vocab = write_flagship_bundle(path, decoder=True)
    # the encoder and CTC head are phase 3's, bit for bit
    base, _, _ = load_inference_bundle(os.path.join(WORK,
                                                    "conformer_bundle"))
    full, meta, _ = load_inference_bundle(path)
    mine = full.state_dict()
    for k, v in base.state_dict().items():
        if not k.startswith("decoder."):
            check(torch.equal(v, mine[k]), f"decoder bundle {k} == the "
                  "flagship bundle's")
    check(meta["decoder_conf"]["r_num_blocks"] == 3, "3 + 3 decoder blocks")
    n_layers = FLAGSHIP_ENCODER["num_blocks"]
    lm = write_char_bigram_arpa(
        [t for t, _ in synthetic_texts(vocab)],
        os.path.join(WORK, "decoders", "flagship_bigram.arpa"))
    cpu_ip = InferencePredictor(path, device="cpu")
    host = BeamSearchDecoder(vocab, **BEAM_CONF)
    check(host.engine == "native", "flagship host beam: native engine")
    out = {"host_beam": host, "cpu_ip": cpu_ip, "path": path}
    runs = []

    def card_batch(decoder, conf):
        pred = MASRPredictor(path, decoder=decoder, decoder_configs=conf,
                             device=dev, warmup=False)
        # the main path: counts read around predict_batch alone
        reset_launches()
        t0 = time.perf_counter()
        res = pred.predict_batch(wavs)
        wall = time.perf_counter() - t0
        launches = layer_kernel("conformer").launches
        check(launches == n_layers, f"flagship {decoder}: {launches} layer "
              f"launches == {n_layers} per encode")
        return pred, res, wall, launches

    # host prefix beam: the CPU engine on the card's probs
    pred, res, wall, launches = card_batch("ctc_beam_search",
                                           decoder_configs(
                                               "ctc_beam_search"))
    speech, lens = pred.featurize_batch(wavs)
    probs, out_lens = pred.predictor.predict(speech, lens)
    utts = [probs[i][:int(out_lens[i])] for i in range(len(wavs))]
    want = host.decode_batch_beam_search_offline(utts)
    check([r["text"] for r in res] == [t for _, t in want],
          "flagship ctc_beam_search: card texts == CPU beam on the card's "
          "probs")
    out["probs"] = utts
    runs.append({"decoder": "ctc_beam_search", "launches": launches,
                 "predict_batch_s": wall, "texts_equal": len(wavs)})

    # attention rescoring: predict of each utterance (predict_batch decodes
    # greedily under attention_rescoring, as masr_tpu's does), against the
    # CPU n-best and the CPU rescore_hyps on the card's encoder rows
    pred, res, wall, launches = card_batch(
        "attention_rescoring", decoder_configs("attention_rescoring"))
    check([r["text"] for r in res] == [
        greedy_decoder(p, vocab)[1] for p in utts],
        "flagship attention_rescoring predict_batch: the greedy texts")
    reset_launches()
    t0 = time.perf_counter()
    res = [pred.predict(w) for w in wavs]
    wall = time.perf_counter() - t0
    launches = layer_kernel("conformer").launches
    check(launches == n_layers * len(wavs), f"flagship attention_rescoring "
          f"predict: {launches} layer launches == {n_layers} x {len(wavs)}")
    err, excess, top, parted, n_hyps = 0.0, 0.0, 0.0, [], 0
    nbest_beam = rescoring_beam(vocab)
    for i, (r, w) in enumerate(zip(res, wavs)):
        enc, probs, out_lens = pred.predictor.encode_for_rescoring(
            *pred.featurize_batch([w]))
        L = int(out_lens[0])
        nbest = [(s, ids) for s, ids in nbest_beam.decode_nbest(
            probs[0][:L], RESCORE_NBEST) if ids]
        hyps = [ids for _, ids in nbest]
        kw = dict(reverse_weight=pred.rescoring_reverse_weight,
                  nbest_pad=RESCORE_NBEST)
        att_card = pred.predictor.rescore(enc, L, hyps, **kw)
        att_cpu = cpu_ip.rescore(enc.cpu(), L, hyps, **kw)
        diff = np.abs(att_card - att_cpu)
        err = max(err, float(diff.max()))
        excess = max(excess, float((diff / (RESCORE_ATOL + RESCORE_ULPS
                                            * np.abs(att_cpu))).max()))
        top = max(top, float(np.abs(att_cpu).max()))
        n_hyps += len(hyps)
        totals = att_cpu + pred.rescoring_ctc_weight * np.asarray(
            [s for s, _ in nbest])
        best = int(np.argmax(totals))
        if r["text"] != "".join(vocab[t] for t in hyps[best]):
            gap = float(np.sort(totals)[-1] - np.sort(totals)[-2])
            parted.append(gap)
            check(gap <= 2 * SCORE_ATOL, f"flagship attention_rescoring "
                  f"utterance {i}: card text differs from the CPU's with a "
                  f"top-2 gap {gap}")
    check(excess <= 1.0, f"rescore_hyps card vs CPU: max abs err {err} at "
          f"|scores| up to {top}, {excess} of {RESCORE_ATOL} + "
          f"{RESCORE_ULPS} x |score|")
    check(pred.rescoring_reverse_weight == 0.3, "reverse_weight 0.3")
    out.update(rescore_pred=pred, enc=enc, out_lens=out_lens,
               rescore_hyps=hyps)
    runs.append({"decoder": "attention_rescoring", "launches": launches,
                 "predict_s": wall, "rescore_max_abs_err": err,
                 "rescore_max_abs_score": top,
                 "rescore_err_over_tolerance": excess,
                 "hypotheses": n_hyps, "reverse_weight": 0.3,
                 "texts_equal": len(wavs) - len(parted),
                 "parted_top2_gaps": parted})

    # the device beam, with and without the dense bigram: the port's CPU
    # device beam on the card's probs
    for with_lm in (False, True):
        conf = decoder_configs("ctc_beam_search_device",
                               lm if with_lm else None, 0.5, 1.0)
        pred, res, wall, launches = card_batch("ctc_beam_search_device",
                                               conf)
        p_t, l_t = pred.predictor.predict_device(speech, lens)
        kw = dict(pred._device_beam_conf)
        if with_lm:
            check(kw["lm_table"].is_cuda and tuple(kw["lm_table"].shape)
                  == (VOCAB + 1, VOCAB), "dense bigram (V+1, V) on the card")
        kw_cpu = dict(kw, lm_table=None if kw["lm_table"] is None
                      else kw["lm_table"].cpu())
        want = decode_batch_device(p_t.cpu(), l_t.cpu(), vocab, **kw_cpu)
        check([r["text"] for r in res] == [t for _, t in want],
              f"flagship device beam (LM {with_lm}): card texts == CPU")
        s_err = max(abs(r["score"] - s) for r, (s, _) in zip(res, want))
        check(s_err <= SCORE_ATOL, f"device beam scores card vs CPU {s_err}")
        runs.append({"decoder": "ctc_beam_search_device"
                     + (" + dense bigram" if with_lm else ""),
                     "launches": launches, "predict_batch_s": wall,
                     "score_max_abs_err": s_err, "texts_equal": len(wavs),
                     **{k: v for k, v in conf.items()
                        if k != "language_model_path"}})
        out["device_beam" + ("_lm" if with_lm else "")] = (p_t, l_t, kw)
    # the other encoders' rows on a decoder path: the Squeezeformer
    # flagship (row 6, its 3 + 3-block decoder) and the static-chunk
    # Conformer (row 5, no row 1) with attention_rescoring
    for name, static, kernel in (("squeezeformer", 0, "squeezeformer"),
                                 ("conformer", STATIC_CHUNK, "flash")):
        other = os.path.join(WORK, f"{name}_{'static_' if static else ''}"
                             "bundle")
        write_flagship_bundle(other, name, static_chunk=static)
        pred = MASRPredictor(other, decoder="attention_rescoring",
                             decoder_configs=decoder_configs(
                                 "attention_rescoring"), device=dev,
                             warmup=False)
        reset_launches()
        res = pred.predict(wavs[-1])
        got = (flash_kernel() if kernel == "flash"
               else layer_kernel(kernel)).launches
        check(got == n_layers and isinstance(res["text"], str)
              and layer_kernel("conformer").launches == 0,
              f"{name}{' static' if static else ''} attention_rescoring: "
              f"{got} launches of its kernel == {n_layers} per encode")
        runs.append({"decoder": "attention_rescoring", "model": name
                     + (" static chunk" if static else ""),
                     "kernel": kernel, "launches": got})
    emit({"phase": "decoders_flagship", "card": smi, "B": len(wavs),
          "T_out": max(len(u) for u in utts), "beam": BEAM_CONF,
          "device_beam": DEVICE_BEAM, "runs": runs,
          "seconds": time.perf_counter() - t_phase})
    return out


def phase_decoders_stream(dev, flag, stream_path, wavs):
    """Two-pass predict_stream of the decoder flagship (attention
    rescoring over every window's encoder rows, 12 chunk launches a
    window) against the CPU decoders replayed on the card's window probs
    and rows; and a 32-slot BatchStreamSession with ctc_beam_search_device
    on the stream bundle (12 chunk launches per dispatch): each stream's
    text equals its own device-beam predict_stream, and a closed slot
    reopens fresh. → (two-pass end-of-stream seconds, rescore seconds,
    engine beam-step seconds)."""
    from masr_tpu_torch.infer.batch_stream import BatchStreamSession
    from masr_tpu_torch.infer.predictor import MASRPredictor
    t_phase = time.perf_counter()
    n_layers = FLAGSHIP_ENCODER["num_blocks"]
    gpu = MASRPredictor(flag["path"], decoder="attention_rescoring",
                        decoder_configs=decoder_configs(
                            "attention_rescoring"), device=dev)
    dec = gpu.beam_search_decoder
    chunks, orig_chunk = [], dec.decode_chunk
    dec.decode_chunk = lambda p: (chunks.append(np.array(p)),
                                  orig_chunk(p))[1]
    rescores, orig_pick = [], gpu._pick_rescored

    def pick(enc, enc_len, nbest):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = orig_pick(enc, enc_len, nbest)
        rescores.append((time.perf_counter() - t0, enc.cpu(),
                         [(s, ids) for s, ids in nbest if ids], r))
        return r

    gpu._pick_rescored = pick
    steps = count_chunk_steps(gpu)
    wav = wavs[3]
    reset_launches()
    text, end_s = stream_text(gpu, wav)
    launches = chunk_launches()
    check(launches == n_layers * len(steps), f"two-pass: {launches} chunk "
          f"launches == {n_layers} x {len(steps)} windows")
    check(len(rescores) == 1 and rescores[0][3]["text"] == text,
          "one rescoring at the end of the stream")
    # the CPU decoders replayed over the card's window probs and rows
    cpu_dec = rescoring_beam(gpu._vocab_list)
    for p in chunks:
        cpu_dec.decode_chunk(p)
    _, enc_rows, nbest, _ = rescores[0]
    want_nbest = [(s, ids) for s, ids in cpu_dec.nbest_state(RESCORE_NBEST)
                  if ids]
    check([ids for _, ids in nbest] == [ids for _, ids in want_nbest],
          "two-pass n-best card == CPU on the card's probs")
    att = flag["cpu_ip"].rescore(enc_rows, enc_rows.shape[1],
                                 [ids for _, ids in nbest],
                                 reverse_weight=gpu.rescoring_reverse_weight,
                                 nbest_pad=RESCORE_NBEST)
    totals = att + gpu.rescoring_ctc_weight * np.asarray(
        [s for s, _ in nbest])
    want = "".join(gpu._vocab_list[t] for t in nbest[int(np.argmax(
        totals))][1])
    gap = float(np.sort(totals)[-1] - np.sort(totals)[-2]) \
        if len(totals) > 1 else None
    check(text == want or gap <= 2 * SCORE_ATOL, f"two-pass text {text!r} "
          f"== CPU replay {want!r} (top-2 gap {gap})")
    two_pass = {"windows": len(steps), "launches": launches,
                "hidden_rows": int(enc_rows.shape[1]),
                "nbest": len(nbest), "text_equal_cpu": text == want,
                "end_of_stream_s": end_s, "rescore_s": rescores[0][0]}
    # the Squeezeformer's two-pass stream: row 8, 12 launches a window
    sq = MASRPredictor(write_stream_bundle(os.path.join(
        WORK, "squeezeformer_bundle")), decoder="attention_rescoring",
        decoder_configs=decoder_configs("attention_rescoring"), device=dev,
        warmup=False)
    sq_steps = count_chunk_steps(sq)
    reset_launches()
    sq_text, _ = stream_text(sq, wav)
    sq_launches = chunk_launches("squeezeformer")
    check(sq_steps and sq_launches == n_layers * len(sq_steps)
          and chunk_launches() == 0 and sq_text is not None,
          f"Squeezeformer two-pass: {sq_launches} chunk launches == "
          f"{n_layers} x {len(sq_steps)} windows")
    two_pass["squeezeformer"] = {"windows": len(sq_steps),
                                 "launches": sq_launches}

    # the engine: every slot's beam steps on each dispatch's probs
    pred = MASRPredictor(stream_path, decoder="ctc_beam_search_device",
                         decoder_configs=dict(DEVICE_BEAM), device=dev,
                         fused_frontend=False)
    refs = [stream_text(pred, w, len(w))[0] for w in wavs]
    sess = BatchStreamSession(
        pred.predictor, pred._vocab_list, max_streams=ENGINE_STREAMS,
        preprocess_conf=pred.predictor.meta["preprocess_conf"],
        decoder="ctc_beam_search_device", decoder_conf=dict(DEVICE_BEAM))
    beam_s, orig_beam = [], sess._beam_step
    dispatches = []

    def timed_beam(probs, valids):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = orig_beam(probs, valids)
        torch.cuda.synchronize()
        beam_s.append(time.perf_counter() - t0)
        dispatches.append(len(valids))
        return r

    sess._beam_step = timed_beam
    streams = [wavs[k % len(wavs)] for k in range(ENGINE_STREAMS)]
    slots = [sess.open() for _ in streams]
    late = [3 * (k % 8) + k // 8 for k in range(len(streams))]
    n_pieces = max(len(w) // PIECE + 1 + d for w, d in zip(streams, late))
    texts = [None] * len(streams)
    # the main path: counts read around the engine run alone
    reset_launches()
    t0 = time.perf_counter()
    for i in range(n_pieces):
        items = [(slot, w[(i - d) * PIECE:(i - d + 1) * PIECE],
                  (i - d + 1) * PIECE >= len(w))
                 for slot, w, d in zip(slots, streams, late)
                 if 0 <= i - d and (i - d) * PIECE < len(w)]
        if items:
            for slot, r in sess.feed_many(items).items():
                if r is not None:
                    texts[slots.index(slot)] = r["text"]
    wall = time.perf_counter() - t0
    launches_e, n_dispatch = chunk_launches(), len(dispatches)
    check(launches_e == n_layers * n_dispatch, f"engine: {launches_e} chunk "
          f"launches == {n_layers} x {n_dispatch} dispatches")
    equal = sum(t == refs[k % len(wavs)] for k, t in enumerate(texts))
    check(equal == len(streams), f"engine device-beam texts == "
          f"predict_stream's: {equal} of {len(streams)}")
    for slot in slots:
        sess.close(slot)
    again = sess.open()
    r = sess.feed(again, wavs[0], is_end=True)
    check(r is not None and r["text"] == refs[0], "a closed slot reopens "
          "with a fresh beam")
    sess.close(again)
    emit({"phase": "decoders_stream", "two_pass": two_pass,
          "engine": {"streams": ENGINE_STREAMS, "decoder":
                     "ctc_beam_search_device", **DEVICE_BEAM,
                     "dispatches": n_dispatch, "launches": launches_e,
                     "texts_equal_predict_stream": equal,
                     "reopened_slot_equal": True, "wall_s": wall},
          "seconds": time.perf_counter() - t_phase})
    return end_s, rescores[0][0], beam_s[:n_dispatch]


EVAL_LAUNCHES = ("train_layer_fwd", "train_layer_bwd", "ctc_fwd", "ctc_bwd",
                 "full_context_layer")


def evaluate_captured(tr, trainer, ckpt, decoder, family):
    """trainer.evaluate(ckpt, decoder) with its eval steps' outputs and the
    hypotheses captured; counts read around the call alone. → (outputs per
    batch, hypotheses, (error, loss), wall seconds, launches (train layer,
    its backward, CTC, its backward, full-context layer))."""
    seen, hyps = [], []
    orig = {n: getattr(tr, n) for n in ("eval_step", "eval_step_rescoring",
                                        "cer")}

    def capture(name):
        def fn(*a):
            out = orig[name](*a)
            seen.append([x.detach() if torch.is_tensor(x) else x
                         for x in out])
            return out
        return fn

    tr.eval_step = capture("eval_step")
    tr.eval_step_rescoring = capture("eval_step_rescoring")
    tr.cer = lambda ref, hyp: (hyps.append(hyp), orig["cer"](ref, hyp))[1]
    try:
        reset_launches()
        reset_train_launches()
        t0 = time.perf_counter()
        result = trainer.evaluate(resume_model=ckpt, decoder=decoder)
        wall = time.perf_counter() - t0
        launches = (*train_launches(family), layer_kernel(family).launches)
    finally:
        for n, f in orig.items():
            setattr(tr, n, f)
    n = FLAGSHIP_ENCODER["num_blocks"]
    batches = len(seen)
    check(batches > 0 and launches == (n * batches, 0, batches, 0,
                                       n * batches),
          f"{family} eval {decoder}: launches (train layer, its backward, "
          f"CTC, its backward, full-context layer) {launches} for "
          f"{batches} batches")
    return seen, hyps, result, wall, launches


def phase_decoders_eval(dev, corpus):
    """The training phase's last checkpoint evaluated by MASRTrainer on
    the card with attention_rescoring and ctc_beam_search_device: per eval
    batch 12 training-layer forwards, 1 CTC forward and 12 full-context
    layer launches; the texts equal the same decoders' on the CPU over the
    card's probs (and encoder rows). Then phase 20's layer_norm
    Squeezeformer checkpoint with ctc_beam_search_device: its rows 7, 4 and
    6, 12 + 1 + 12 launches per batch."""
    from masr_tpu_torch.data.text_featurizer import TextFeaturizer
    from masr_tpu_torch.decoders.device_beam import decode_batch_device
    from masr_tpu_torch.training import trainer as tr
    from masr_tpu_torch.training.checkpoints import load_checkpoint
    t_phase = time.perf_counter()
    root = os.path.join(WORK, "train")
    ckpt = os.path.join(root, "models", "conformer_streaming_fbank",
                        "last_model")
    conf = dict(train_config(corpus, root, TRAIN_EPOCHS + 1),
                ctc_beam_search_decoder_conf=decoder_configs(
                    "attention_rescoring"))
    card = tr.MASRTrainer(conf, device=dev)
    cpu = tr.MASRTrainer(conf, device="cpu")
    ds, _, _ = cpu._setup_dataloader(False)
    cpu._setup_model(ds.feature_dim, ds.vocab_size)
    cpu.model.load_state_dict(load_checkpoint(ckpt)[0]["model"])
    tf = TextFeaturizer(corpus["vocab"])
    vocab = tf.vocab_list
    rows = []
    for decoder in ("attention_rescoring", "ctc_beam_search_device"):
        seen, hyps, (error, loss), wall, launches = evaluate_captured(
            tr, card, ckpt, decoder, "conformer")
        want = []
        for out in seen:
            if decoder == "attention_rescoring":
                _, enc, probs, lens = out
                cpu._resolve_eval_decoder(vocab, decoder)
                want += [t for _, t in cpu._rescore_batch(
                    enc.cpu(), probs.cpu().numpy(), lens.cpu().numpy(), tf,
                    RESCORE_NBEST, 0.3, 0.3)]
            else:
                _, probs, lens = out
                want += [t for _, t in decode_batch_device(
                    probs.cpu(), lens.cpu(), vocab,
                    **dict(card._device_beam_conf(vocab), lm_table=None))]
        diff = [i for i, (a, b) in enumerate(zip(hyps, want)) if a != b]
        check(len(hyps) == len(want) > 0 and not diff,
              f"eval {decoder}: card texts == CPU decoders on the card's "
              f"outputs ({len(hyps)} and {len(want)} texts, differing at "
              f"{diff})")
        rows.append({"decoder": decoder, "model": "conformer",
                     "batches": len(seen), "utterances": len(hyps),
                     "cer": error, "loss": loss,
                     "launches": dict(zip(EVAL_LAUNCHES, launches)),
                     "texts_equal_cpu": len(hyps), "wall_s": wall})
    sq_root = os.path.join(WORK, "sq_train")
    sq_ckpt = os.path.join(sq_root, "models", "squeezeformer_streaming_fbank",
                           "last_model")
    sq = tr.MASRTrainer(dict(sq_train_config(corpus, sq_root,
                                             TRAIN_EPOCHS + 1),
                             ctc_beam_search_decoder_conf=DEVICE_BEAM),
                        device=dev)
    seen, hyps, (error, loss), wall, launches = evaluate_captured(
        tr, sq, sq_ckpt, "ctc_beam_search_device", "squeezeformer")
    rows.append({"decoder": "ctc_beam_search_device",
                 "model": "squeezeformer (layer_norm conv)",
                 "batches": len(seen), "utterances": len(hyps),
                 "cer": error, "loss": loss,
                 "launches": dict(zip(EVAL_LAUNCHES, launches)),
                 "wall_s": wall})
    emit({"phase": "decoders_eval", "checkpoint": ckpt,
          "sq_checkpoint": sq_ckpt, "runs": rows,
          "seconds": time.perf_counter() - t_phase})


def phase_decoder_times(dev, flag, wavs, stream_times, smi):
    """Host and card times of the decoders on the flagship's outputs (B=8,
    the card's probs): the native beam 300 on the shortest and the longest
    utterance, the Python engine and the native one on the shortest's
    first PYTHON_FRAMES frames, the thread pool over the 8; the device
    beam at B=8 offline (wall; the profiler's device time and
    kernel launches over its first PROFILED_FRAMES frames) and the
    engine's beam step per dispatch; one rescore at N=10; the two-pass
    end-of-stream latency."""
    from masr_tpu_torch.decoders.beam_search import BeamSearchDecoder
    from masr_tpu_torch.decoders.device_beam import decode_batch_device
    t_phase = time.perf_counter()
    host, utts = flag["host_beam"], flag["probs"]
    short = min(range(len(utts)), key=lambda i: len(utts[i]))
    longest = max(range(len(utts)), key=lambda i: len(utts[i]))
    native_s = {}
    for i in (short, longest):
        t0 = time.perf_counter()
        host.decode_beam_search_offline(utts[i])
        native_s[len(utts[i])] = time.perf_counter() - t0
    t0 = time.perf_counter()
    host.decode_batch_beam_search_offline(utts)
    pool_s = time.perf_counter() - t0
    python = BeamSearchDecoder(flag["cpu_ip"].vocab_list, use_native=False,
                               **BEAM_CONF)
    check(python.engine == "python", "the Python engine")
    head_probs = utts[short][:PYTHON_FRAMES]
    t0 = time.perf_counter()
    py_res = python.decode_beam_search_offline(head_probs)
    python_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    nat_res = host.decode_beam_search_offline(head_probs)
    native_head_s = time.perf_counter() - t0

    beams = {}
    for key in ("device_beam", "device_beam_lm"):
        p_t, l_t, kw = flag[key]
        vocab = flag["cpu_ip"].vocab_list
        decode_batch_device(p_t, l_t, vocab, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        decode_batch_device(p_t, l_t, vocab, **kw)
        beams[key] = {"wall_s": time.perf_counter() - t0,
                      "frames": int(p_t.shape[1])}
    # the device time of the first PROFILED_FRAMES frames (the profiler
    # over a whole call's launches costs tens of seconds)
    p_t, l_t, kw = flag["device_beam"]
    short_p = p_t[:, :PROFILED_FRAMES].contiguous()
    short_l = torch.clamp(l_t, max=PROFILED_FRAMES)

    def head():
        return decode_batch_device(short_p, short_l, vocab, **kw)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    head()
    wall = time.perf_counter() - t0
    ms, launches = profiled_launches(head)
    beams["device_beam"]["first_frames"] = {
        "frames": PROFILED_FRAMES, "wall_s": wall, "device_ms": ms,
        "kernel_launches": launches,
        "launches_per_frame": launches / PROFILED_FRAMES}
    pred, enc, lens = flag["rescore_pred"], flag["enc"], flag["out_lens"]
    hyps = flag["rescore_hyps"]
    hyps = (hyps * RESCORE_NBEST)[:RESCORE_NBEST]
    rescore_s = []
    for _ in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pred.predictor.rescore(enc[-1:], int(lens[-1]), hyps,
                               reverse_weight=0.3, nbest_pad=RESCORE_NBEST)
        rescore_s.append(time.perf_counter() - t0)
    end_s, pick_s, beam_step_s = stream_times
    emit({"phase": "decoder_times", "card": smi,
          "host_beam": {"beam": BEAM_CONF["beam_size"],
                        "native_s_by_T_out": native_s,
                        "T_out": [len(u) for u in utts],
                        "thread_pool_B8_s": pool_s,
                        "python_s": python_s, "python_T_out":
                        len(head_probs), "native_s_same_frames":
                        native_head_s,
                        "python_text_equal_native": py_res[1] == nat_res[1],
                        "python_score_minus_native": py_res[0] - nat_res[0]},
          "device_beam_B8": {**beams, **DEVICE_BEAM},
          "engine_beam_step_s": {"median": float(np.median(beam_step_s)),
                                 "p90": float(np.percentile(beam_step_s,
                                                            90)),
                                 "dispatches": len(beam_step_s)},
          "rescore_N10_s": {"median": float(np.median(rescore_s[2:])),
                            "runs": rescore_s,
                            "T_out": int(lens[-1])},
          "two_pass_end_of_stream_s": end_s,
          "two_pass_rescore_s": pick_s,
          "seconds": time.perf_counter() - t_phase})


# --------------------------------------------------------------------------- #
# phases 30-33: export, the eval CLI, long audio, the server
# --------------------------------------------------------------------------- #
QUANT_ATOL = 0.05        # bf16 / int8 bundle probs vs f32 (test_quant_bundle)
# phase 12's bundles, whose probs sit near blank: gates ~10x and ~5x the
# bf16 and int8 readings there
QUANT_GATE = {"bf16": 5e-3, "int8": 1e-2}
LENGTH_BUCKET = 200      # the predictor's padding of full-context frames
SERVER_STREAMS = 4
SERVER_LOAD = 40         # /recognition requests: each server's latency sample
SERVER_LOAD_LONG = 2     # /recognition_long_audio requests of 20 s each


def config_file(conf, path):
    """A config dict as a YAML file for the CLIs."""
    import yaml
    with open(path, "w", encoding="utf-8") as f:
        yaml.safe_dump(conf, f, allow_unicode=True)
    return path


def padded_features(pred, wavs):
    """The batch's features padded as the predictor pads them."""
    speech, lens = pred.featurize_batch(wavs)
    T = speech.shape[1]
    T_pad = -(-max(T, 8) // LENGTH_BUCKET) * LENGTH_BUCKET
    return np.pad(speech, ((0, 0), (0, T_pad - T), (0, 0))), lens


def model_probs(model, speech, lens, dev):
    """The full-context CTC probs of a model in eval mode → numpy."""
    with torch.no_grad():
        probs, out = model.eval().get_encoder_out(
            torch.from_numpy(speech).to(dev),
            torch.as_tensor(lens, device=dev))
    return probs.cpu().numpy(), out.cpu().numpy()


def bundle_vs_model(path, model, wavs, dev, family):
    """The bundle loaded by MASRPredictor on the card: its probs of the
    utterances against the trained model's on the same padded features,
    the layer kernel's launches of the encode (counted around it alone),
    its greedy texts and its size."""
    from masr_tpu_torch.infer.predictor import MASRPredictor
    pred = MASRPredictor(model_dir=path, device=dev)
    speech, lens = padded_features(pred, wavs)
    want, want_lens = model_probs(model, speech, lens, dev)
    reset_launches()
    got, got_lens = pred.predictor.predict(speech, lens)
    launches = layer_kernel(family).launches
    check((got_lens == want_lens).all() and np.isfinite(got).all(),
          f"{path}: lengths equal, probs finite")
    err = max(float(np.abs(got[b, :n] - want[b, :n]).max())
              for b, n in enumerate(want_lens))
    return {"pred": pred, "probs": got, "lens": got_lens, "err": err,
            "launches": launches,
            "texts": [r["text"] for r in pred.predict_batch(wavs)],
            "bytes": os.path.getsize(os.path.join(path, "model.msgpack"))}


def phase_export(dev, corpus, wavs):
    """Phase 12's Conformer checkpoint exported through MASRTrainer.export
    (f32) and the export_model CLI (bf16, int8), phase 20's BatchNorm
    Squeezeformer checkpoint through MASRTrainer.export (f32, batch_stats
    in the bundle), phase 3's seeded flagship written again as bf16 and
    int8; each bundle on the card: probs of the 8 utterances vs the
    model's, 12 layer launches per encode; phase 12's quantized bundles
    within QUANT_GATE of the f32 one with its greedy texts, the seeded
    ones within QUANT_ATOL, their texts' error rate against f32's
    reported."""
    from masr_tpu_torch import export_model
    from masr_tpu_torch.infer import flax_msgpack
    from masr_tpu_torch.infer.bundle import (load_inference_bundle,
                                             save_inference_bundle)
    from masr_tpu_torch.training.trainer import MASRTrainer
    from masr_tpu_torch.utils.metrics import edit_distance
    t_phase = time.perf_counter()
    root = os.path.join(WORK, "export")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    n = FLAGSHIP_ENCODER["num_blocks"]
    train_root = os.path.join(WORK, "train")
    conf = train_config(corpus, train_root, TRAIN_EPOCHS + 1)
    ckpt = os.path.join(train_root, "models", "conformer_streaming_fbank",
                        "last_model")
    trainer = MASRTrainer(conf, device=dev)
    paths = {"f32": trainer.export(save_model_path=os.path.join(root, "f32"),
                                   resume_model=ckpt)}
    conf_path = config_file(conf, os.path.join(root, "conformer.yml"))
    for quant in ("bf16", "int8"):
        paths[quant] = export_model.main([
            "--configs", conf_path, "--resume_model", ckpt,
            "--use_gpu", str(torch.device(dev).type == "cuda"),
            "--save_model_path", os.path.join(root, quant),
            "--save_quant", quant])
    for quant, p in paths.items():
        check(p == os.path.join(root, quant, "conformer_streaming_fbank",
                                "inference_model"),
              f"{quant} bundle at masr_tpu's directory name: {p}")
    runs = {q: bundle_vs_model(p, trainer.model, wavs, dev, "conformer")
            for q, p in paths.items()}
    f32 = runs["f32"]
    check(f32["err"] <= PROBS_ATOL, f"f32 bundle probs vs the trained "
          f"model {f32['err']} <= {PROBS_ATOL}")
    for quant in ("bf16", "int8"):
        r = runs[quant]
        r["err_vs_f32"] = max(
            float(np.abs(r["probs"][b, :k] - f32["probs"][b, :k]).max())
            for b, k in enumerate(f32["lens"]))
        check(r["err_vs_f32"] <= QUANT_GATE[quant], f"{quant} bundle probs "
              f"vs f32 {r['err_vs_f32']} <= {QUANT_GATE[quant]}")
        check(r["texts"] == f32["texts"], f"{quant} greedy texts == f32's")
    for q, r in runs.items():
        check(r["launches"] == n, f"{q} bundle: {r['launches']} row-1 "
              f"launches per encode, want {n}")

    sq_root = os.path.join(WORK, "sq_train", "batch_norm")
    sq_trainer = MASRTrainer(sq_train_config(corpus, sq_root, 1,
                                             conv_norm="batch_norm"),
                             device=dev)
    sq_path = sq_trainer.export(
        save_model_path=os.path.join(root, "sq_f32"),
        resume_model=os.path.join(sq_root, "models",
                                  "squeezeformer_streaming_fbank",
                                  "last_model"))
    with open(os.path.join(sq_path, "model.msgpack"), "rb") as f:
        stats = flax_msgpack.unpackb(f.read()).get("batch_stats", {})
    check(len(stats) > 0, "the Squeezeformer bundle holds batch_stats")
    sq = bundle_vs_model(sq_path, sq_trainer.model, wavs, dev,
                         "squeezeformer")
    check(sq["err"] <= PROBS_ATOL, f"Squeezeformer bundle probs vs the "
          f"trained model {sq['err']} <= {PROBS_ATOL}")
    check(sq["launches"] == SQ_ENCODER["num_blocks"], f"Squeezeformer "
          f"bundle: {sq['launches']} row-6 launches per encode")

    # phase 3's seeded flagship, whose frames decode to text (phase 12's
    # 24-step model emits blanks): its weights written again as bf16 and
    # int8 and held to QUANT_ATOL on probs that are not saturated at blank.
    # Its random weights leave near ties between tokens that quantization
    # flips, so its texts' error rate against f32 is reported, not gated
    seeded_src = os.path.join(WORK, "conformer_bundle")
    seeded_model, meta, vocab = load_inference_bundle(seeded_src)
    with open(os.path.join(seeded_src, "model.msgpack"), "rb") as f:
        variables = flax_msgpack.unpackb(f.read())
    seeded_paths = {"f32": seeded_src}
    for quant in ("bf16", "int8"):
        seeded_paths[quant] = os.path.join(root, f"seeded_{quant}")
        save_inference_bundle(
            seeded_paths[quant], meta["use_model"], meta["streaming"],
            meta["input_dim"], vocab, meta["mean"], meta["istd"],
            meta["encoder_conf"], meta["decoder_conf"], meta["model_conf"],
            meta["preprocess_conf"], variables, quant=quant)
    seeded_model.to(dev)
    seeded = {q: bundle_vs_model(p, seeded_model, wavs, dev, "conformer")
              for q, p in seeded_paths.items()}
    f32_texts = seeded["f32"]["texts"]
    check(all(f32_texts), f"seeded flagship: every utterance decodes to "
          f"text {f32_texts}")
    for quant in ("bf16", "int8"):
        r = seeded[quant]
        check(r["err"] <= QUANT_ATOL, f"seeded {quant} bundle probs vs f32 "
              f"{r['err']} <= {QUANT_ATOL}")
        r["cer_vs_f32"] = sum(edit_distance(a, b) for a, b in
                              zip(f32_texts, r["texts"])) / sum(
                                  map(len, f32_texts))
        check(r["launches"] == n, f"seeded {quant} bundle: {r['launches']} "
              "row-1 launches per encode")
    emit({"phase": "export", "checkpoint": ckpt, "utterances": len(wavs),
          "probs_atol": PROBS_ATOL, "quant_gate": QUANT_GATE,
          "quant_atol_seeded": QUANT_ATOL,
          "conformer": {q: {"bundle": paths[q], "bytes": r["bytes"],
                            "probs_err_vs_model": r["err"],
                            "probs_err_vs_f32": r.get("err_vs_f32"),
                            "row1_launches_per_encode": r["launches"],
                            "texts_equal_f32": r["texts"] == f32["texts"],
                            "texts_nonempty": sum(map(bool, r["texts"]))}
                        for q, r in runs.items()},
          "squeezeformer_batch_norm": {
              "bundle": sq_path, "bytes": sq["bytes"],
              "probs_err_vs_model": sq["err"],
              "row6_launches_per_encode": sq["launches"]},
          "seeded_flagship": {q: {
              "bytes": r["bytes"], "probs_err_vs_f32": r["err"],
              "cer_vs_f32": r.get("cer_vs_f32"),
              "texts_equal_f32": r["texts"] == f32_texts,
              "texts_nonempty": sum(map(bool, r["texts"])),
              "text_chars": sum(map(len, r["texts"]))}
              for q, r in seeded.items()},
          "seconds": time.perf_counter() - t_phase})
    return {"conf": conf, "conf_path": conf_path, "ckpt": ckpt,
            "f32": paths["f32"], "f32_pred": f32["pred"]}


def phase_eval_cli(dev, exported):
    """masr_tpu_torch.eval.main on phase 12's corpus and checkpoint: its
    error rate and loss == MASRTrainer.evaluate in process; per eval batch
    12 row-3 and 1 row-4 forward launches and 12 row-1 launches."""
    from masr_tpu_torch import eval as eval_cli
    from masr_tpu_torch.training import trainer as tr
    t_phase = time.perf_counter()
    batches, orig = [], tr.eval_step

    def counted(*a):
        batches.append(1)
        return orig(*a)

    tr.eval_step = counted
    try:
        reset_launches()
        reset_train_launches()
        t0 = time.perf_counter()
        cli = eval_cli.main([
            "--configs", exported["conf_path"],
            "--resume_model", exported["ckpt"],
            "--use_gpu", str(torch.device(dev).type == "cuda")])
        wall = time.perf_counter() - t0
        launches = (*train_launches("conformer"),
                    layer_kernel("conformer").launches)
    finally:
        tr.eval_step = orig
    n, b = FLAGSHIP_ENCODER["num_blocks"], len(batches)
    check(b > 0 and launches == (n * b, 0, b, 0, n * b), f"eval CLI "
          f"launches (train layer, its backward, CTC, its backward, "
          f"full-context layer) {launches} for {b} batches")
    inproc = tr.MASRTrainer(exported["conf"], device=dev).evaluate(
        resume_model=exported["ckpt"])
    check(cli == inproc, f"eval CLI (error, loss) {cli} == in process "
          f"{inproc}")
    emit({"phase": "eval_cli", "batches": b, "cer": cli[0], "loss": cli[1],
          "equal_in_process": cli == inproc,
          "launches": dict(zip(EVAL_LAUNCHES, launches)), "wall_s": wall,
          "seconds": time.perf_counter() - t_phase})


def speech_like(duration_s, seed, level=0.3):
    """tests/test_vad_silero.py's voiced signal: swept f0, 5 harmonics,
    syllable-rate AM (silero scores it > 0.9)."""
    rs = np.random.RandomState(seed)
    t = np.arange(int(duration_s * 16000)) / 16000
    f0 = 120 + 40 * np.sin(2 * np.pi * 3 * t)
    phase = np.cumsum(2 * np.pi * f0 / 16000)
    voiced = sum((0.4 / k) * np.sin(k * phase) for k in range(1, 6))
    env = np.clip(np.sin(2 * np.pi * 4 * t), 0, 1)
    return (level * voiced * env
            + 0.01 * rs.standard_normal(len(t))).astype(np.float32)


def long_recording(n_items=30, seed=3):
    """Silences of 0.6-1.4 s between the example corpus's sentences
    (SyntheticTTS, 7 speakers) and speech_like stretches of 1-2 s, in
    turn: ~80 s of audio."""
    from masr_tpu_torch.audio.synth_tts import SyntheticTTS
    tts = SyntheticTTS(sample_rate=16000)
    rs = np.random.RandomState(seed)
    sents = corpus_sentences()
    parts = []
    for k in range(n_items):
        parts.append(np.zeros(int(rs.uniform(0.6, 1.4) * 16000), np.float32))
        if k % 2 == 0:
            parts.append(tts.render(sents[rs.randint(len(sents))],
                                    spk_id=k % 7))
        else:
            parts.append(speech_like(rs.uniform(1.0, 2.0), seed=k))
    parts.append(np.zeros(16000, np.float32))
    return np.concatenate(parts).astype(np.float32)


@contextlib.contextmanager
def silero_runs(store):
    """Counts the silero model's batched window passes (VADPredictor's
    offline path) into `store`."""
    from masr_tpu_torch.infer.vad import SileroVAD
    orig = SileroVAD.run_sequence

    def counted(self, *a, **k):
        store.append(1)
        return orig(self, *a, **k)

    SileroVAD.run_sequence = counted
    try:
        yield store
    finally:
        SileroVAD.run_sequence = orig


def phase_long_audio(dev):
    """predict_long of an ~80 s recording on the example bundle and on
    phase 3's flagship, card vs CPU: the silero model (not the heuristic)
    ran, the segments are the CPU's, the text and score are the CPU's (a
    text may part only at a near tie, as elsewhere), 12 row-1 launches per
    predict_batch group of 16 segments; the VAD timed apart."""
    from masr_tpu_torch.infer.predictor import MASRPredictor
    t_phase = time.perf_counter()
    rec = long_recording()
    check(60 <= len(rec) / 16000 <= 120, f"recording of {len(rec) / 16000} "
          "s, want 60-120")
    rows = []
    for name, path in (("example", TINY_BUNDLE),
                       ("flagship", os.path.join(WORK, "conformer_bundle"))):
        gpu = MASRPredictor(model_dir=path, device=dev)
        cpu = MASRPredictor(model_dir=path, device="cpu", warmup=False)
        n = int(gpu.predictor.meta["encoder_conf"]["num_blocks"])
        runs, encode_s = [], []
        orig = gpu.predict_batch

        def timed(*a, **k):
            t0 = time.perf_counter()
            out = orig(*a, **k)
            encode_s.append(time.perf_counter() - t0)
            return out

        gpu.predict_batch = timed
        with silero_runs(runs):
            # the main path: counts read around predict_long alone
            reset_launches()
            t0 = time.perf_counter()
            got = gpu.predict_long(rec)
            wall = time.perf_counter() - t0
            launches = layer_kernel("conformer").launches
            t0 = time.perf_counter()
            segs = gpu._vad.get_speech_timestamps(rec, 16000)
            vad_s = time.perf_counter() - t0
        check(gpu._vad.silero is not None and len(runs) == 2,
              f"the silero model ran ({len(runs)} batched passes), not the "
              "heuristic")
        groups = -(-len(segs) // 16)
        check(len(segs) > 16 and launches == n * groups, f"{name}: {launches} "
              f"row-1 launches for {len(segs)} segments, want {n} x {groups} "
              "groups")
        want = cpu.predict_long(rec)
        check(segs == cpu._vad.get_speech_timestamps(rec, 16000),
              "segments == the CPU port's VAD's")
        parted = None
        if got["text"] != want["text"]:
            wavs = [rec[s["start"]:s["end"]] for s in segs]
            parted = probs_card_vs_cpu(gpu, cpu, wavs)[:2]
        else:
            check(abs(got["score"] - want["score"]) <= 0.01, f"{name} score "
                  f"{got['score']} == CPU {want['score']} (2 places)")
        rows.append({"bundle": name, "segments": len(segs),
                     "groups": groups, "row1_launches": launches,
                     "text_equal_cpu": got["text"] == want["text"],
                     "score": got["score"], "score_cpu": want["score"],
                     "parted_probs_check": parted,
                     "text_chars": len(got["text"]),
                     "predict_long_s": wall, "vad_s": vad_s,
                     "encode_s": float(np.sum(encode_s))})
    emit({"phase": "long_audio", "seconds_audio": len(rec) / 16000,
          "silero": True, "runs": rows,
          "seconds": time.perf_counter() - t_phase})
    return rec


async def ws_connect(srv):
    import websockets
    return await websockets.connect(f"ws://127.0.0.1:{srv.ws_port}/")


def run_async(coro):
    """asyncio.run(coro) on a thread of its own (as a server thread would
    run it) → its result; its exception is raised here."""
    box = {}

    def target():
        try:
            box["out"] = asyncio.run(coro)
        except BaseException as e:     # re-raised in the caller's thread
            box["err"] = e

    t = threading.Thread(target=target)
    t.start()
    t.join()
    if "err" in box:
        raise box["err"]
    return box["out"]


def free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def start_server(pred, **kw):
    """An ASRServer on 127.0.0.1 with free ports, its REST and WebSocket
    servers on threads of their own."""
    from masr_tpu_torch.infer.server import ASRServer
    srv = ASRServer(pred, host="127.0.0.1", port=free_port(),
                    ws_port=free_port(), **kw)
    srv.start(block=False)
    time.sleep(0.5)
    return srv


def stop_server(srv):
    srv.stop()
    srv._httpd.server_close()


def http(srv, path, body=None, ctype="application/octet-stream"):
    """→ (status, JSON reply) of a POST (body) or GET (None)."""
    import urllib.error
    import urllib.request
    req = urllib.request.Request(
        f"http://127.0.0.1:{srv.port}{path}", data=body,
        headers={"Content-Type": ctype} if body is not None else {})
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def multipart(raw):
    boundary = "smoke7d1f"
    body = (f"--{boundary}\r\nContent-Disposition: form-data; "
            f'name="audio"; filename="a.wav"\r\nContent-Type: audio/wav'
            f"\r\n\r\n").encode() + raw + f"\r\n--{boundary}--\r\n".encode()
    return body, f"multipart/form-data; boundary={boundary}"


def wav_bytes(wav, path):
    from masr_tpu_torch.audio.io import write_wave
    write_wave(path, wav, 16000)
    with open(path, "rb") as f:
        return f.read()


def pct_ms(xs):
    """Latencies in seconds → their count, p50 and p90 in ms."""
    return {"n": len(xs),
            "p50": float(np.percentile(xs, 50) * 1000) if xs else None,
            "p90": float(np.percentile(xs, 90) * 1000) if xs else None}


def rest_load(srv, pred, raws, long_raws):
    """The REST latency sample, on a server that has answered nothing yet:
    SERVER_LOAD /recognition requests over the utterances in turn, one at
    a time, then the long-audio requests; every reply a success, each
    /recognition text the predictor's in process. → the client's times and
    /stats' percentiles, both over exactly these successful requests."""
    want = [pred.predict(r)["text"] for r in raws]
    times, long_times = [], []
    for k in range(SERVER_LOAD):
        t0 = time.perf_counter()
        status, r = http(srv, "/recognition", raws[k % len(raws)])
        times.append(time.perf_counter() - t0)
        check(status == 200 and r["code"] == 0
              and r["result"] == want[k % len(raws)],
              f"request {k}: {status} {r} == in process")
    for raw in long_raws:
        t0 = time.perf_counter()
        status, r = http(srv, "/recognition_long_audio", raw)
        long_times.append(time.perf_counter() - t0)
        check(status == 200 and r["code"] == 0, f"long audio {status} {r}")
    status, stats = http(srv, "/stats")
    rec = stats["endpoints"]["/recognition"]
    long = stats["endpoints"]["/recognition_long_audio"]
    check(status == 200 and rec["count"] == SERVER_LOAD
          and long["count"] == len(long_raws)
          and rec["errors"] == long["errors"] == 0, f"/stats {stats}")
    return {"rest_ms": pct_ms(times),
            "rest_stats_ms": {"n": rec["count"], "p50": rec["p50_ms"],
                              "p90": rec["p90_ms"]},
            "long_ms": pct_ms(long_times),
            "long_stats_ms": {"n": long["count"], "p50": long["p50_ms"],
                              "p90": long["p90_ms"]}}


def drive_rest(srv, pred, raw, long_raw, launches_per_encode, counter):
    """Every REST endpoint of a running server: /recognition (raw body
    and multipart; the text and score == the predictor's in process; the
    kernel's launches counted around each request alone; with use_pun and
    is_itn on, == punctuation then ITN of the plain text),
    /recognition_long_audio (== predict_long in process), an empty body
    (400), unknown paths (404), /stats."""
    out = {}
    reset_launches()
    status, r = http(srv, "/recognition", raw)
    out["recognition_launches"] = counter()
    want = pred.predict(raw)
    check(status == 200 and r["code"] == 0 and r["result"] == want["text"]
          and r["score"] == want["score"], f"/recognition {status} {r} == "
          f"in process {want}")
    check(out["recognition_launches"] == launches_per_encode,
          f"/recognition launched {out['recognition_launches']}, want "
          f"{launches_per_encode} from the handler thread")
    body, ctype = multipart(raw)
    status, m = http(srv, "/recognition", body, ctype)
    check(status == 200 and m["result"] == want["text"],
          f"multipart /recognition {m}")
    reset_launches()
    status, lr = http(srv, "/recognition_long_audio", long_raw)
    out["long_launches"] = counter()
    want_long = pred.predict_long(long_raw)
    check(status == 200 and lr["result"] == want_long["text"]
          and lr["score"] == want_long["score"],
          f"/recognition_long_audio {lr} == in process {want_long}")
    check(out["long_launches"] > 0 and out["long_launches"]
          % launches_per_encode == 0, f"long audio launches "
          f"{out['long_launches']}")
    srv.use_pun = srv.is_itn = True
    status, p = http(srv, "/recognition", raw)
    srv.use_pun = srv.is_itn = False
    post = want["text"]
    if post:
        post = pred.inverse_text_normalization(pred.pun_predictor(post))
    check(status == 200 and p["result"] == post, f"use_pun + is_itn "
          f"{p['result']!r} == ITN(punctuation({want['text']!r}))")
    check(http(srv, "/recognition", b"")[0] == 400, "empty body: 400")
    check(http(srv, "/no_such_path", raw)[0] == 404, "unknown POST: 404")
    check(http(srv, "/no_such_path")[0] == 404, "unknown GET: 404")
    status, stats = http(srv, "/stats")
    rec = stats["endpoints"]["/recognition"]
    check(status == 200 and rec["count"] == SERVER_LOAD + 4
          and rec["errors"] == 1, f"/stats {stats}")
    out.update(text=r["result"], punctuated=p["result"],
               long_text_chars=len(lr["result"]))
    return out


def pcm_pieces(wav, piece=STRIDE_SAMPLES):
    """int16 PCM messages of `piece` samples, the last one ending b"end"."""
    pcm = (np.clip(wav, -1, 1) * 32767).astype(np.int16).tobytes()
    step = 2 * piece
    return [pcm[i:i + step] + (b"end" if i + step >= len(pcm) else b"")
            for i in range(0, len(pcm), step)]


def reference_replies(feed, pieces, reset=None):
    """The replies a stream should get: feed(payload, is_end) per message,
    then reset() → [(expects a reply, its text)]."""
    out = []
    for msg in pieces:
        end = msg.endswith(b"end")
        r = feed(msg[:-3] if end else msg, end)
        out.append((end or r is not None,
                    (r or {"text": ""})["text"]))
    if reset is not None:
        reset()
    return out


async def ws_stream(client, pieces, expected, latencies):
    """Send the messages, read a reply where one is expected (timing it
    from its message's send) → the replies' texts."""
    texts = []
    for msg, (reply, _) in zip(pieces, expected):
        t0 = time.perf_counter()
        await client.send(msg)
        if reply:
            r = json.loads(await client.recv())
            latencies.append(time.perf_counter() - t0)
            check(r["code"] == 0, f"stream reply {r}")
            texts.append(r["result"])
    return texts


def phase_server(dev, exported, rec, stream_path, wavs):
    """ASRServer on 127.0.0.1 over the example bundle, phase 30's f32
    flagship bundle, phase 15's seeded Squeezeformer (rows 6 and 8) and
    phase 23's static-chunk Conformer bundle (REST),
    and with max_streams (greedy and ctc_beam_search_device) over phase
    7's seeded flagship without dB normalization (`stream_path`: its
    peaked frames decode to text, where the 24-step model of phase 30
    emits blanks). Each REST server first answers the latency sample
    (rest_load), then REST == the predictor in process; the 8 utterances
    `wavs` streamed through the single-predictor path == predict_stream,
    a second connection refused as busy; the 8 utterances through the
    engine in two rounds of 4 concurrent streams == predict_stream (host
    frontend), a fifth refused; the device-beam server == the engine in
    process; kernel launches per request from the server's threads (12
    row-1 per /recognition, 12 row-5 on the static bundle, 12 row-2 per
    window or dispatch); every WebSocket reply timed."""
    import websockets
    from masr_tpu_torch.audio.synth_tts import SyntheticTTS
    from masr_tpu_torch.infer.batch_stream import BatchStreamSession
    from masr_tpu_torch.infer.predictor import MASRPredictor
    t_phase = time.perf_counter()
    root = os.path.join(WORK, "server")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    tts = SyntheticTTS(sample_rate=16000)
    utt = tts.render(HELD_OUT[0][0], spk_id=HELD_OUT[0][1])
    raw = wav_bytes(utt, os.path.join(root, "short.wav"))
    raws = [wav_bytes(w, os.path.join(root, f"utt{k}.wav"))
            for k, w in enumerate(wavs)]
    long_raws = [wav_bytes(rec[k * 5 * 16000:(k * 5 + 20) * 16000],
                           os.path.join(root, f"long{k}.wav"))
                 for k in range(SERVER_LOAD_LONG)]
    stream_wav = np.concatenate([utt, tts.render(HELD_OUT[1][0],
                                                 spk_id=HELD_OUT[1][1])])
    n = FLAGSHIP_ENCODER["num_blocks"]
    rows = {}

    def single_ws(srv, pred, family):
        """A stream through the single-predictor path == predict_stream in
        process over the same messages; a second connection is busy; the
        chunk kernel's launches per window. Then each of the 8 utterances
        on a connection of its own, every reply == predict_stream's and
        timed."""
        def expect(wav):
            pieces = pcm_pieces(wav)
            return pieces, reference_replies(
                lambda p, e: pred.predict_stream(p, is_end=e), pieces,
                pred.reset_stream)

        pieces, expected = expect(stream_wav)
        load = [expect(w) for w in wavs]
        steps = count_chunk_steps(pred)
        latencies = []

        async def scenario():
            first = await ws_connect(srv)
            texts = await ws_stream(first, pieces[:2], expected[:2], [])
            second = await ws_connect(srv)
            busy = json.loads(await second.recv())
            await second.close()
            texts += await ws_stream(first, pieces[2:], expected[2:], [])
            await first.close()
            return texts, busy

        async def each_alone():
            out = []
            for ps, ex in load:
                c = await ws_connect(srv)
                out.append(await ws_stream(c, ps, ex, latencies))
                await c.close()
            return out

        reset_launches()
        texts, busy = run_async(scenario())
        launches = chunk_launches(family)
        per = int(pred.predictor.meta["encoder_conf"]["num_blocks"])
        want = [t for reply, t in expected if reply]
        check(texts == want, f"WebSocket stream {texts} == predict_stream "
              f"{want}")
        check(busy["code"] == 1 and "busy" in busy["msg"], f"second "
              f"connection refused as busy: {busy}")
        check(len(steps) > 0 and launches == per * len(steps),
              f"{launches} chunk launches for {len(steps)} windows")
        got = run_async(each_alone())
        check(got == [[t for reply, t in ex if reply] for _, ex in load],
              "each utterance's WebSocket replies == predict_stream's")
        return {"ws_final": texts[-1], "ws_windows": len(steps),
                "ws_row2_launches": launches,
                "ws_reply_ms": pct_ms(latencies)}

    # the example bundle, the f32 flagship and phase 15's seeded
    # Squeezeformer: REST and streams
    for name, path, family in (
            ("example", TINY_BUNDLE, "conformer"),
            ("flagship_f32", exported["f32"], "conformer"),
            ("squeezeformer", os.path.join(WORK, "squeezeformer_bundle"),
             "squeezeformer")):
        pred = MASRPredictor(model_dir=path, device=dev, use_pun=True)
        per = int(pred.predictor.meta["encoder_conf"]["num_blocks"])
        srv = start_server(pred)
        try:
            row = rest_load(srv, pred, raws, long_raws)
            row.update(drive_rest(srv, pred, raw, long_raws[0], per,
                                  lambda: layer_kernel(family).launches))
            row.update(single_ws(srv, pred, family))
        finally:
            stop_server(srv)
        rows[name] = row

    # the static-chunk Conformer: REST through the flash kernel
    pred = MASRPredictor(model_dir=os.path.join(
        WORK, "conformer_static_bundle"), device=dev, use_pun=True)
    srv = start_server(pred)
    try:
        row = rest_load(srv, pred, raws, long_raws)
        row.update(drive_rest(srv, pred, raw, long_raws[0], n,
                              lambda: flash_kernel().launches))
        check(layer_kernel("conformer").launches == 0, "no row-1 launch on "
              "the static-chunk bundle")
    finally:
        stop_server(srv)
    rows["static_chunk"] = row

    # the engine behind max_streams, on a flagship without dB normalization
    # (as the engine phase: its gain is per call); the audio over a -60 dB
    # noise floor: the engine refuses digital silence
    rs = np.random.RandomState(7)
    noisy = [(w + 1e-3 * rs.standard_normal(len(w))).astype(np.float32)
             for w in wavs]

    def engine_server(decoder, conf):
        pred = MASRPredictor(model_dir=stream_path, device=dev,
                             decoder=decoder, decoder_configs=conf)
        srv = start_server(pred, max_streams=SERVER_STREAMS)
        dispatches, orig = [], srv.batch_session._dispatch

        def counted(*a):
            dispatches.append(1)
            return orig(*a)

        srv.batch_session._dispatch = counted
        return pred, srv, dispatches

    def engine_reference(pred, decoder, conf, pieces):
        sess = BatchStreamSession(
            pred.predictor, pred._vocab_list,
            preprocess_conf=pred.predictor.meta["preprocess_conf"],
            max_streams=1, decoder=decoder, decoder_conf=conf)
        slot = sess.open()
        return reference_replies(
            lambda p, e: sess.feed(slot, np.frombuffer(p, np.int16).astype(
                np.float32) / 32768.0 if p else np.zeros(0, np.float32), e),
            pieces)

    host = MASRPredictor(model_dir=stream_path, device=dev,
                         fused_frontend=False)
    pieces = [pcm_pieces(w) for w in noisy]
    for decoder, conf in (("ctc_greedy", None),
                          ("ctc_beam_search_device", dict(DEVICE_BEAM))):
        pred, srv, dispatches = engine_server(decoder, conf)
        check(srv.batch_session.decoder == decoder, f"engine decoder "
              f"{srv.batch_session.decoder}")
        engine_ref = [engine_reference(pred, decoder, conf, p)
                      for p in pieces]
        if decoder == "ctc_greedy":
            finals = [reference_replies(
                lambda p, e: host.predict_stream(p, is_end=e), ps,
                host.reset_stream)[-1][1] for ps in pieces]
            check([r[-1][1] for r in engine_ref] == finals, "engine in "
                  "process == predict_stream (host frontend)")
        latencies = []

        async def scenario():
            texts, refused = [], None
            for r0 in range(0, len(pieces), SERVER_STREAMS):
                clients = [await ws_connect(srv)
                           for _ in range(SERVER_STREAMS)]
                if refused is None:
                    await asyncio.sleep(0.3)  # every handler has its slot
                    fifth = await ws_connect(srv)
                    refused = json.loads(await fifth.recv())
                    await fifth.close()
                texts += await asyncio.gather(*[
                    ws_stream(c, p, e, latencies) for c, p, e in
                    zip(clients, pieces[r0:r0 + SERVER_STREAMS],
                        engine_ref[r0:r0 + SERVER_STREAMS])])
                for c in clients:
                    await c.close()
                while any(srv.batch_session._in_use):  # the slots closed
                    await asyncio.sleep(0.01)
            return texts, refused

        try:
            reset_launches()
            t0 = time.perf_counter()
            texts, refused = run_async(scenario())
            wall = time.perf_counter() - t0
            launches = chunk_launches()
        finally:
            stop_server(srv)
        want = [[t for reply, t in e if reply] for e in engine_ref]
        check(texts == want, f"{decoder} server streams {texts} == the "
              f"engine in process {want}")
        check(refused["code"] == 1 and "slots" in refused["msg"],
              f"a fifth connection refused: {refused}")
        check(len(dispatches) > 0 and launches == n * len(dispatches),
              f"{decoder} server: {launches} chunk launches for "
              f"{len(dispatches)} dispatches")
        check(all(t[-1] for t in texts), f"{decoder}: every stream decodes "
              "to text")
        rows[f"engine_{decoder}"] = {
            "streams": len(pieces), "concurrent": SERVER_STREAMS,
            "messages": sum(map(len, pieces)),
            "dispatches": len(dispatches), "row2_launches": launches,
            "final_chars": [len(t[-1]) for t in texts],
            "ws_reply_ms": pct_ms(latencies), "wall_s": wall}

    emit({"phase": "server", "ws_transport": "websockets",
          "websockets_version": websockets.__version__, "servers": rows,
          "card": card(), "seconds": time.perf_counter() - t_phase})


# --------------------------------------------------------------------------- #
# the Efficient-Conformer: its plain tail through rows 1 and 3 (and 4, 5)
# --------------------------------------------------------------------------- #
EFF_T, EFF_LENS = 150, [(n + 1) // 2 for n in TRAIN_LENS]   # after stride 2
EFF_STREAMS = 8


def seeded_eff_layer(seed, causal, device):
    """A tail layer of configs/efficient_conformer.yml: the flagship
    widths with conv kernel 7 (15 // 2 after the stride), seeded."""
    from masr_tpu_torch.models.conformer import ConformerEncoderLayer
    from masr_tpu_torch.models.weights import seeded_state_dict
    e = EFF_ENCODER
    layer = ConformerEncoderLayer(e["output_size"], e["attention_heads"],
                                  e["linear_units"], EFF_TAIL_KERNEL, causal)
    layer.load_state_dict(seeded_state_dict(layer, seed))
    return layer.to(device).eval()


def phase_eff_kernels(dev, smi):
    """Rows 1 and 3 at the Efficient-Conformer tail's shape (B=8, T'=150,
    K=7, every length halved rounding up, the row-3 mask the [::2, ::2]
    view of a dynamic-chunk mask), causal and not, against their plain
    twins; CUDA-event times (plain, kernel, kernel, plain) with the f32 and
    3xTF32 bounds."""
    from masr_tpu_torch.ops.cuda import conformer_layer as cl
    from masr_tpu_torch.ops.cuda import conformer_layer_train as clt
    t_phase = time.perf_counter()
    serve, train, worst = [], [], {"row1": 0.0, "row3": 0.0}
    fns = (clt.fused_conformer_layer_train,
           clt.fused_conformer_layer_train_plain)
    for causal in (True, False):
        layer = seeded_eff_layer(31 + causal, causal, dev)
        x, lens_t, pos_p = layer_inputs(layer, EFF_LENS, EFF_T, 33, dev)

        def kernel():
            return run_layer(cl.fused_conformer_layer, layer, x, lens_t,
                             pos_p)

        def plain():
            return run_layer(cl.fused_conformer_layer_plain, layer, x,
                             lens_t, pos_p)

        with torch.no_grad():
            got, want = kernel(), plain()
            torch.cuda.synchronize()
            check(bool(torch.isfinite(got).all()), "row 1 output finite")
            err = max((got[b, :n] - want[b, :n]).abs().max().item()
                      for b, n in enumerate(EFF_LENS))
            check(err <= KERNEL_ATOL, f"row 1 vs plain {err} <= "
                  f"{KERNEL_ATOL} (K={EFF_TAIL_KERNEL}, T'={EFF_T}, "
                  f"causal={causal})")
            runs = alternate(kernel, plain)
        worst["row1"] = max(worst["row1"], err)
        serve.append({"causal": causal, "max_abs_err": err,
                      "kernel_ms": runs["kernel"], "plain_ms": runs["plain"],
                      **layer_bound(layer, EFF_LENS, EFF_T)})
        args = train_layer_inputs(layer, 34 + causal, dev, half=True)
        check(tuple(args[2].shape) == (8, EFF_T, EFF_T)
              and not args[2].is_contiguous()
              and args[4].tolist() == EFF_LENS,
              "row 3 takes the strided mask view and the halved lengths")
        for rates in ((0.0, 0.0), (0.1, 0.1)):
            case = check_train_layer(fns, layer, args, rates)
            worst["row3"] = max(worst["row3"], case["max_abs_err"])
            train.append({"causal": causal, **case})
        fwd, bwd = time_train_layer({"kernel": fns[0], "plain": fns[1]},
                                    layer, args, (0.1, 0.1))
        train[-1].update({"fwd_kernel_ms": fwd["kernel"],
                          "fwd_plain_ms": fwd["plain"],
                          "bwd_kernel_ms": bwd["kernel"],
                          "bwd_plain_ms": bwd["plain"],
                          **train_layer_bound(layer, args)})
    emit({"phase": "eff_kernels", "card": smi, "B": len(EFF_LENS),
          "T": EFF_T, "lens": EFF_LENS, "D": 256, "heads": 4, "ffn": 2048,
          "conv_kernel": EFF_TAIL_KERNEL, "atol": KERNEL_ATOL,
          "grad_rtol": GRAD_RTOL, "row1": serve, "row3": train,
          "seconds": time.perf_counter() - t_phase})
    return worst


def phase_eff_flagship(dev):
    """The Efficient-Conformer of configs/efficient_conformer.yml, seeded:
    predict_batch of the 8 utterances (phase_flagship: card vs CPU probs,
    8 row-1 launches per encode) and no chunk-layer launch; then the same
    model with a static chunk of 16 (streaming off, as masr_tpu builds
    it): its warmup and predict_batch launch row 5 8 times per encode and
    row 1 none, probs card vs CPU. → (card predictor, main path's row-1
    launches)."""
    from masr_tpu_torch.infer.predictor import MASRPredictor
    t_phase = time.perf_counter()
    gpu, wavs, launches = phase_flagship(dev, "efficient_conformer")
    check(chunk_kernel("conformer").launches == 0, "no chunk-layer launch "
          "in the Efficient-Conformer's predict_batch")
    path = os.path.join(WORK, "efficient_conformer_static_bundle")
    write_flagship_bundle(path, "efficient_conformer",
                          static_chunk=STATIC_CHUNK)
    per_encode = (EFF_TAIL, 0, 0)
    reset_launches()
    static = MASRPredictor(model_dir=path, device=dev)  # warmup: predict
    warm = encode_launches()
    check(warm == per_encode, f"static warmup launches {warm} == "
          f"{per_encode} (flash, layer kernels)")
    reset_launches()
    t0 = time.perf_counter()
    texts = static.predict_batch(wavs)
    wall = time.perf_counter() - t0
    got = encode_launches()
    check(got == per_encode, f"static predict_batch launches {got} == "
          f"{per_encode} (flash, layer kernels)")
    check(chunk_kernel("conformer").launches == 0, "no chunk-layer launch")
    cpu = MASRPredictor(model_dir=path, device="cpu", warmup=False)
    err, compared, t_out = probs_card_vs_cpu(static, cpu, wavs)
    cpu_texts = cpu.predict_batch(wavs)
    emit({"phase": "eff_static", "static_chunk_size": STATIC_CHUNK,
          "streaming": static.streaming, "T_out": t_out,
          "warmup_launches": warm[0], "launches": got[0],
          "probs_max_abs_err": err, "probs_atol": PROBS_ATOL,
          "argmax_frames_compared": compared,
          "texts_equal_cpu": sum(a["text"] == b["text"]
                                 for a, b in zip(texts, cpu_texts)),
          "predict_batch_s": wall,
          "seconds": time.perf_counter() - t_phase})
    return gpu, wavs, launches


def phase_eff_stream(dev, flagship, wavs, smi):
    """The Efficient-Conformer's predict_stream (both frontends, whole and
    in 0.2 s pieces, card vs CPU: phase_stream) and an 8-stream engine
    (phase_engine: texts == predict_stream's, 4 slots on the CPU), every
    window and dispatch eager (no chunk-layer launch, as masr_tpu streams
    this family); the window latency at B=1 (p50, p90 over n=12)."""
    t_phase = time.perf_counter()
    path = write_stream_bundle(flagship.model_dir)
    phase_stream(dev, path, wavs[3], "efficient_conformer")
    phase_engine(dev, path, wavs, "efficient_conformer", EFF_STREAMS)
    reset_launches()
    window = window_latency(dev, path, wavs)
    check(chunk_kernel("conformer").launches == 0,
          "the eager chunk steps launch no chunk-layer kernel")
    emit({"phase": "eff_stream_times", "card": smi,
          "predict_stream": {**window, "n": len(window["window_s"])},
          "seconds": time.perf_counter() - t_phase})
    return path


def eff_train_config(corpus, save_dir, max_epoch, dropout=True):
    """configs/efficient_conformer.yml as a dict at its widths (vocabulary
    4000), on phase 12's corpus at B=8, with warmup_steps 8 and accum_grad
    1 (the config's 4 leaves 2 updates in the run's 8 steps) so that the
    loss falls within the run."""
    conf = train_config(corpus, save_dir, max_epoch, dropout)
    r = 0.1 if dropout else 0.0
    conf["encoder_conf"] = dict(EFF_ENCODER, dropout_rate=r,
                                positional_dropout_rate=r,
                                attention_dropout_rate=r)
    conf["train_conf"] = dict(conf["train_conf"], accum_grad=1)
    conf["use_model"] = "efficient_conformer"
    return conf


def phase_eff_train(dev, corpus, smi):
    """MASRTrainer(dict config, device=cuda).train of the Efficient-
    Conformer on phase 12's corpus: one epoch of 8 steps at B=8, every
    step 8 + 8 row-3 and 1 + 1 row-4 launches, the loss per label token
    falling; the first step at dropout 0 against the CPU; step walls and
    the card's idle share over one profiled step. → (trainer, its
    config).

    The first step is compared twice (first_step_card_vs_cpu's gates).
    The config's hybrid loss: the loss and the grads of the CTC head and
    of the decoder's last rows. The CTC loss alone (ctc_weight 1): the
    encoder's grads, head and tail. Through the attention loss every
    encoder grad passes the decoder FFN's ReLU derivative, and on the card
    1-4 of its units take the other side of 0 on some batches (the
    kernels' f32-level differences): a jump past CPU_GRAD_RTOL, as
    first_step_card_vs_cpu says of the subsampling and decoder layers."""
    from masr_tpu_torch.training.trainer import MASRTrainer
    t_phase = time.perf_counter()
    root = os.path.join(WORK, "eff_train")
    shutil.rmtree(root, ignore_errors=True)
    save = os.path.join(root, "models")
    first = first_step_card_vs_cpu(
        eff_train_config(corpus, root, 1, dropout=False),
        ["decoder.left_decoder.after_norm.weight",
         "decoder.right_decoder.output_layer.weight", "ctc.ctc_lo.weight"])
    ctc_conf = eff_train_config(corpus, root, 1, dropout=False)
    ctc_conf["model_conf"] = dict(ctc_conf["model_conf"], ctc_weight=1.0)
    first_ctc = first_step_card_vs_cpu(
        ctc_conf,
        ["encoder.embed.out.0.weight",
         "encoder.encoders.0.self_attn.pos_bias_u",
         "encoder.encoders.3.conv_module.depthwise_conv.weight",
         "encoder.encoders.7.self_attn.linear_q.weight",
         "encoder.encoders.11.conv_module.depthwise_conv.weight",
         "encoder.encoders.11.norm_final.weight", "ctc.ctc_lo.weight"])
    conf = eff_train_config(corpus, root, 1)
    rows = []
    reset_train_launches()
    with clocked_train_steps(rows, "efficient_conformer"):
        trainer = MASRTrainer(conf, device="cuda")
        trainer.train(save_model_path=save, augment_conf_path=None)
    step = (2 * EFF_TAIL, EFF_TAIL, 2, 1)
    check(len(rows) == TRAIN_STEPS_PER_EPOCH, f"{len(rows)} steps")
    for i, r in enumerate(rows):
        check(r["launches"] == list(step), f"step {i} launches "
              f"{r['launches']}, want {list(step)} (train layer, its "
              f"backward, CTC, its backward)")
    per_token = np.asarray([r["loss"] / r["tokens"] for r in rows])
    check(bool(np.isfinite(per_token).all()), "every step's loss finite")
    head, tail = float(per_token[:4].mean()), float(per_token[-4:].mean())
    check(tail < head, f"loss per label token falls: first 4 steps {head}, "
          f"last 4 {tail}")
    emit({"phase": "eff_train", "card": smi, "steps": len(rows),
          "batch": len(TRAIN_LENS), "launches_per_step": list(step),
          "loss_per_token_first4": head, "loss_per_token_last4": tail,
          **step_times(rows), "first_step_card_vs_cpu": first,
          "first_step_ctc_loss_card_vs_cpu": first_ctc,
          "profile": profile_train_steps(trainer),
          "seconds": time.perf_counter() - t_phase})
    return trainer, conf, rows


def phase_eff_export(dev, trainer, conf, wavs):
    """The trained Efficient-Conformer through MASRTrainer.export (f32): the
    bundle's probs of the 8 utterances on the card == the trained model's
    (PROBS_ATOL), 8 row-1 launches per encode; the eval CLI on its
    checkpoint: per batch 8 row-3 and 1 row-4 forward launches and 8
    row-1, (error, loss) == MASRTrainer.evaluate in process."""
    from masr_tpu_torch import eval as eval_cli
    from masr_tpu_torch.training import trainer as tr
    t_phase = time.perf_counter()
    root = os.path.join(WORK, "eff_train")
    ckpt = os.path.join(root, "models", "efficient_conformer_streaming_fbank",
                        "last_model")
    path = trainer.export(save_model_path=os.path.join(root, "export"),
                          resume_model=ckpt)
    check(path.endswith(os.path.join("efficient_conformer_streaming_fbank",
                                     "inference_model")),
          f"bundle at masr_tpu's directory name: {path}")
    r = bundle_vs_model(path, trainer.model, wavs, dev, "efficient_conformer")
    check(r["err"] <= PROBS_ATOL, f"f32 bundle probs vs the trained model "
          f"{r['err']} <= {PROBS_ATOL}")
    check(r["launches"] == EFF_TAIL, f"{r['launches']} row-1 launches per "
          f"encode, want {EFF_TAIL}")
    conf_path = config_file(conf, os.path.join(root, "eff.yml"))
    batches, orig = [], tr.eval_step

    def counted(*a):
        batches.append(1)
        return orig(*a)

    tr.eval_step = counted
    try:
        reset_launches()
        reset_train_launches()
        cli = eval_cli.main(["--configs", conf_path, "--resume_model", ckpt,
                             "--use_gpu", "True"])
        launches = (*train_launches("efficient_conformer"),
                    layer_kernel("efficient_conformer").launches)
    finally:
        tr.eval_step = orig
    b = len(batches)
    want = (EFF_TAIL * b, 0, b, 0, EFF_TAIL * b)
    check(b > 0 and launches == want, f"eval CLI launches {launches} == "
          f"{want} for {b} batches")
    inproc = tr.MASRTrainer(conf, device=dev).evaluate(resume_model=ckpt)
    check(cli == inproc, f"eval CLI {cli} == in process {inproc}")
    emit({"phase": "eff_export", "bundle": path, "bytes": r["bytes"],
          "probs_err_vs_model": r["err"], "row1_launches_per_encode":
          r["launches"], "texts_nonempty": sum(map(bool, r["texts"])),
          "eval_cli": {"batches": b, "cer": cli[0], "loss": cli[1],
                       "launches": dict(zip(EVAL_LAUNCHES, launches)),
                       "equal_in_process": cli == inproc},
          "seconds": time.perf_counter() - t_phase})


# --------------------------------------------------------------------------- #
# phases 39-43: DeepSpeech2, and training as train.py runs it by default
# --------------------------------------------------------------------------- #
DS2_STREAMS = 8
ADAM_ATOL = 1e-6          # one fused Adam update vs the unfused one
FBANK_ATOL = 1e-3         # device fbank vs host fbank, log mel energies
AUG_STEPS = TRAIN_STEPS_PER_EPOCH // 2   # one epoch of half_corpus


def all_kernels():
    """Every row's wrapper by name (its .launches count forward and
    backward calls)."""
    from masr_tpu_torch.ops.cuda import ctc_loss as C
    return {"conformer_layer": layer_kernel("conformer"),
            "chunk_layer": chunk_kernel("conformer"),
            "conformer_layer_train": train_layer_kernel("conformer"),
            "ctc_loss": C.ctc_loss, "rel_pos_attention": flash_kernel(),
            "squeezeformer_layer": layer_kernel("squeezeformer"),
            "squeezeformer_layer_train": train_layer_kernel("squeezeformer"),
            "chunk_layer_sq": chunk_kernel("squeezeformer")}


def reset_all_launches():
    for fn in all_kernels().values():
        fn.launches = 0
        if hasattr(fn, "backward_launches"):
            fn.backward_launches = 0


def all_launches():
    return {name: fn.launches for name, fn in all_kernels().items()}


def check_no_launch(what):
    got = {k: n for k, n in all_launches().items() if n}
    check(not got, f"{what}: no kernel of the eight launched ({got})")


def write_ds2_bundle(path, streaming=True, use_gru=False, layers=None):
    """A DS2 of configs/deepspeech2.yml's widths (5 x 1024, fbank 80,
    V=4000; `layers` cuts the depth), weights drawn from seed 0 (the CTC
    head x8, as the other flagships), written by the port's exporter
    (infer/bundle.py), CMVN from the example bundle → (vocab, parameter
    count)."""
    from masr_tpu_torch.infer.bundle import save_inference_bundle
    from masr_tpu_torch.models.registry import build_model
    from masr_tpu_torch.models.weights import (seeded_state_dict,
                                               to_flax_variables)
    with open(os.path.join(TINY_BUNDLE, "inference.json"),
              encoding="utf-8") as f:
        tiny = json.load(f)
    enc = dict(DS2_ENCODER, use_gru=use_gru)
    if layers:
        enc["num_rnn_layers"] = layers
    model = build_model("deepspeech2", 80, VOCAB, streaming=streaming,
                        encoder_conf=enc)
    state = seeded_state_dict(model, seed=0)
    state["ctc.ctc_lo.weight"] *= 8.0
    vocab = train_vocab()
    save_inference_bundle(path, "deepspeech2", streaming, 80, vocab,
                          tiny["mean"], tiny["istd"], enc, {}, {},
                          PREPROCESS, to_flax_variables(state))
    return vocab, sum(p.numel() for p in model.parameters())


# the depth of phase 39's bidirectional and GRU twins (their widths are the
# config's): their CPU references at 5 layers took ~20 s of the script
DS2_TWIN_LAYERS = 2


def phase_ds2_flagship(dev, smi):
    """DS2 at configs/deepspeech2.yml's widths (forward LSTMs), its
    bidirectional twin (streaming off) and a GRU twin (both at
    DS2_TWIN_LAYERS layers), each written by the
    port's exporter: predict_batch of the 8 utterances on the card with no
    kernel launch (the recurrence is cuDNN's), probs card vs CPU within
    PROBS_ATOL and no argmax flip past ARGMAX_MARGIN; the wall time. The
    caller's cuDNN TF32 is on here, as torch's default has it: the DS2
    encoder turns it off for its own forward alone, and must leave it on.
    → (forward LSTM card predictor, utterances, bundle)."""
    t_phase = time.perf_counter()
    runs, out = [], None
    torch.backends.cudnn.allow_tf32 = True
    try:
        for name, streaming, gru in (("lstm", True, False),
                                     ("lstm_bidirect", False, False),
                                     ("gru", True, True)):
            out = ds2_offline_run(dev, name, streaming, gru, runs) or out
    finally:
        torch.backends.cudnn.allow_tf32 = False
    emit({"phase": "ds2_flagship", "card": smi, "encoder": DS2_ENCODER,
          "vocab": VOCAB, "utterances": len(out[1]),
          "caller_cudnn_allow_tf32": True,
          "runs": runs, "seconds": time.perf_counter() - t_phase})
    return out


def ds2_offline_run(dev, name, streaming, gru, runs):
    """One DS2 twin of phase_ds2_flagship → its row appended to runs; the
    forward LSTM's (card predictor, utterances, bundle)."""
    from masr_tpu_torch.infer.predictor import MASRPredictor
    path = os.path.join(WORK, f"ds2_{name}_bundle")
    vocab, n_params = write_ds2_bundle(
        path, streaming, gru, None if name == "lstm" else DS2_TWIN_LAYERS)
    wavs = synthetic_utterances(vocab)
    gpu = MASRPredictor(model_dir=path, device=dev)
    reset_all_launches()
    t0 = time.perf_counter()
    texts = gpu.predict_batch(wavs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check_no_launch(f"ds2 {name} predict_batch")
    t0 = time.perf_counter()
    gpu.predict_batch(wavs)
    wall2 = time.perf_counter() - t0
    cpu = MASRPredictor(model_dir=path, device="cpu", warmup=False)
    err, compared, t_out = probs_card_vs_cpu(gpu, cpu, wavs)
    runs.append({"model": name, "streaming": streaming,
                 "params": n_params, "T_out": t_out,
                 "probs_max_abs_err": err, "probs_atol": PROBS_ATOL,
                 "argmax_frames_compared": compared,
                 "texts_nonempty": sum(bool(t["text"]) for t in texts),
                 "predict_batch_s": [wall, wall2]})
    check(torch.backends.cudnn.allow_tf32, f"ds2 {name}: the caller's "
          "cuDNN TF32 setting is as it was")
    return (gpu, wavs, path) if name == "lstm" else None


def phase_ds2_stream(dev, flagship, wavs, smi):
    """The DS2's predict_stream (both frontends, whole and in 0.2 s
    pieces, card vs CPU: phase_stream), an 8-stream engine (texts ==
    predict_stream's by the top-2-margin rule, 4 slots on the CPU), no
    kernel launch; the window latency at B=1 (p50, p90 over n=12)."""
    t_phase = time.perf_counter()
    path = write_stream_bundle(flagship.model_dir)
    reset_all_launches()
    phase_stream(dev, path, wavs[3], "deepspeech2")
    phase_engine(dev, path, wavs, "deepspeech2", DS2_STREAMS)
    window = window_latency(dev, path, wavs)
    check_no_launch("ds2 streaming")
    emit({"phase": "ds2_stream_times", "card": smi,
          "predict_stream": {**window, "n": len(window["window_s"])},
          "seconds": time.perf_counter() - t_phase})


def ds2_train_config(corpus, save_dir, max_epoch):
    """configs/deepspeech2.yml as a dict at its widths (vocabulary 4000)
    on phase 12's corpus at B=8, warmup_steps 8 so that the loss falls
    within the run."""
    conf = train_config(corpus, save_dir, max_epoch)
    conf["encoder_conf"] = dict(DS2_ENCODER)
    conf["decoder_conf"] = {}
    conf.pop("model_conf")
    conf["train_conf"] = dict(conf["train_conf"], accum_grad=1)
    conf["use_model"] = "deepspeech2"
    return conf


def phase_ds2_train(dev, corpus, wavs, smi):
    """MASRTrainer(dict config, device=cuda).train of the DS2 on phase 12's
    corpus: 8 steps at B=8, each 1 + 1 row-4 launches and no other row,
    the loss per label token falling; the first step card vs CPU (the loss
    and every grad); step walls, audio s/s and the card's idle share over
    one profiled step; export f32 (the bundle's probs == the model's)
    and the eval CLI (1 row-4 forward per batch)."""
    from masr_tpu_torch import eval as eval_cli
    from masr_tpu_torch.models.registry import build_model
    from masr_tpu_torch.training import trainer as tr
    t_phase = time.perf_counter()
    root = os.path.join(WORK, "ds2_train")
    shutil.rmtree(root, ignore_errors=True)
    save = os.path.join(root, "models")
    names = [n for n, _ in build_model(
        "deepspeech2", 80, VOCAB, encoder_conf=DS2_ENCODER).named_parameters()]
    first = first_step_card_vs_cpu(ds2_train_config(corpus, root, 1), names)
    conf = ds2_train_config(corpus, root, 1)
    rows = []
    reset_all_launches()
    with clocked_train_steps(rows):
        trainer = tr.MASRTrainer(conf, device=dev)
        trainer.train(save_model_path=save, augment_conf_path=None)
    run = all_launches()
    check(len(rows) == TRAIN_STEPS_PER_EPOCH, f"{len(rows)} steps")
    for i, r in enumerate(rows):
        check(r["launches"] == [0, 0, 2, 1], f"ds2 step {i} launches "
              f"{r['launches']}, want [0, 0, 2, 1] (train layer, its "
              f"backward, CTC, its backward)")
    others = {k: n for k, n in run.items() if k != "ctc_loss" and n}
    check(not others, f"no other row launched in DS2 training ({others})")
    per_token = np.asarray([r["loss"] / r["tokens"] for r in rows])
    check(bool(np.isfinite(per_token).all()), "every step's loss finite")
    head, tail = float(per_token[:4].mean()), float(per_token[-4:].mean())
    check(tail < head, f"ds2 loss per label token falls: first 4 steps "
          f"{head}, last 4 {tail}")
    profile = profile_train_steps(trainer,
                                  kernel_groups=DS2_PROFILE_GROUPS)
    ckpt = os.path.join(save, "deepspeech2_streaming_fbank", "last_model")
    path = trainer.export(save_model_path=os.path.join(root, "export"),
                          resume_model=ckpt)
    reset_all_launches()
    r = bundle_vs_model(path, trainer.model, wavs, dev, "deepspeech2")
    check(r["err"] <= PROBS_ATOL, f"f32 bundle probs vs the trained model "
          f"{r['err']} <= {PROBS_ATOL}")
    check_no_launch("the DS2 bundle's encode")
    conf_path = config_file(conf, os.path.join(root, "ds2.yml"))
    batches, orig = [], tr.eval_step

    def counted(*a):
        batches.append(1)
        return orig(*a)

    tr.eval_step = counted
    try:
        reset_all_launches()
        cli = eval_cli.main(["--configs", conf_path, "--resume_model", ckpt,
                             "--use_gpu", str(dev.type == "cuda")])
        launches = all_launches()
    finally:
        tr.eval_step = orig
    b = len(batches)
    check(b > 0 and launches["ctc_loss"] == b and sum(launches.values())
          == b, f"eval CLI launches {launches}: want {b} CTC forwards")
    emit({"phase": "ds2_train", "card": smi, "steps": len(rows),
          "batch": len(TRAIN_LENS), "launches_per_step": [0, 0, 2, 1],
          "run_launches": run, "loss_per_token_first4": head,
          "loss_per_token_last4": tail, **step_times(rows),
          "first_step_card_vs_cpu": {
              **{k: v for k, v in first.items() if k != "grad_rel_err"},
              "grad_rel_err_max": max(first["grad_rel_err"].values()),
              "grads_compared": len(first["grad_rel_err"]),
              "gate": CPU_GRAD_RTOL},
          "profile": profile, "export": {"bundle": path, "bytes": r["bytes"],
                                         "probs_err_vs_model": r["err"]},
          "eval_cli": {"batches": b, "cer": cli[0], "loss": cli[1]},
          "seconds": time.perf_counter() - t_phase})
    return rows


def half_corpus(corpus, root):
    """Every other training utterance of phase 12's corpus (32: 4 steps of
    8), its test set, vocabulary and CMVN; the manifests also written as
    binary records (data/binary.py); synthetic noise clips beside them and
    configs/augmentation.json with its noise manifest pointed at them."""
    from masr_tpu_torch.audio.io import write_wave
    from masr_tpu_torch.data.binary import create_manifest_binary
    os.makedirs(root, exist_ok=True)
    out = dict(corpus)
    for split, step in (("train", 2), ("test", 1)):
        with open(corpus[split], encoding="utf-8") as f:
            lines = [l for l in f if l.strip()][::step]
        out[split] = os.path.join(root, f"manifest.{split}")
        with open(out[split], "w", encoding="utf-8") as f:
            f.writelines(lines)
    create_manifest_binary(out["train"], out["test"])
    rs = np.random.RandomState(9)
    noise = []
    for i, seconds in enumerate((1.5, 4.0, 13.0)):
        wav = (0.1 * rs.standard_normal(int(16000 * seconds))).astype(
            np.float32)
        path = os.path.join(os.path.dirname(corpus["train"]),
                            f"noise_{i}.wav")
        write_wave(path, wav, 16000)
        noise.append(json.dumps({"audio_filepath": path, "text": "",
                                 "duration": seconds}) + "\n")
    out["noise"] = os.path.join(os.path.dirname(corpus["train"]),
                                "manifest.noise")
    with open(out["noise"], "w", encoding="utf-8") as f:
        f.writelines(noise)
    with open(os.path.join(REPO, "configs", "augmentation.json"),
              encoding="utf-8") as f:
        items = json.load(f)
    for item in items:
        if item["type"] == "noise":
            item["params"]["noise_manifest_path"] = out["noise"]
    out["augment"] = os.path.join(root, "augmentation.json")
    with open(out["augment"], "w", encoding="utf-8") as f:
        json.dump(items, f)
    return out


def run_aug_train(dev, conf, corpus, root, what):
    """The flagship trained AUG_STEPS steps (one epoch of the half corpus)
    with the augmentation config; every step 12 + 12 row-3 and 1 + 1 row-4
    launches, finite losses. → (rows, trainer)."""
    from masr_tpu_torch.training.trainer import MASRTrainer
    rows = []
    reset_train_launches()
    with clocked_train_steps(rows):
        trainer = MASRTrainer(conf, device=dev)
        trainer.train(save_model_path=os.path.join(root, "models"),
                      augment_conf_path=corpus["augment"])
    n_layers = FLAGSHIP_ENCODER["num_blocks"]
    step = [2 * n_layers, n_layers, 2, 1]
    check(len(rows) == AUG_STEPS, f"{what}: {len(rows)} steps")
    for i, r in enumerate(rows):
        check(r["launches"] == step, f"{what} step {i} launches "
              f"{r['launches']}, want {step}")
        check(r["finite"] and np.isfinite(r["loss"]),
              f"{what} step {i} loss finite")
    return rows, trainer


def phase_train_aug(dev, corpus, phase12_rows, phase12_trainer, smi):
    """The flagship Conformer trained 4 steps with configs/augmentation.json
    (noise p 0.5 from synthetic noise beside phase 12's corpus, speed,
    shift, volume, SpecAugment, SpecSub): 12 + 12 row-3 and 1 + 1 row-4
    launches per step, finite losses; the step wall median beside phase
    13's (phase 12's run, and its first epoch, whose sorted batches span
    the lengths as these do), both split by whether the loader read
    utterances during the step, and the loader's wait before each step;
    this trainer and phase 12's profiled back to back on one batch, phase
    12's 8 longest utterances. → the half corpus."""
    t_phase = time.perf_counter()
    root = os.path.join(WORK, "train_aug")
    shutil.rmtree(root, ignore_errors=True)
    half = half_corpus(corpus, os.path.join(root, "corpus"))
    conf = train_config(half, root, 1)
    rows, trainer = run_aug_train(dev, conf, half, root, "train_aug")
    pipe = trainer._setup_dataloader(True, half["augment"])[0]
    augmentors = [type(a).__name__ for a, _ in
                  pipe._augmentation_pipeline._audio_augmentors
                  + pipe._augmentation_pipeline._feature_augmentors]
    check(len(augmentors) == 6, f"six augmentors built: {augmentors}")
    waits = [r["wait_s"] for r in rows[1:]]
    p12 = step_times(phase12_rows)
    # 4 steps: 2 optimizer updates in each profile at accum_grad 2
    t0 = time.perf_counter()
    same_batch = {
        "phase12_trainer": profile_train_steps(phase12_trainer, n=2),
        "train_aug_trainer": profile_train_steps(
            trainer, n=2, items_from=phase12_trainer)}
    same_batch["seconds"] = time.perf_counter() - t0
    emit({"phase": "train_aug", "card": smi, "steps": len(rows),
          "augmentors": augmentors, **step_times(rows),
          "phase13_step_s_median": p12["step_s_median"],
          "phase13_epoch1_step_s_median": step_times(
              phase12_rows[:TRAIN_STEPS_PER_EPOCH])["step_s_median"],
          "phase13_step_s_median_loader_reading":
              p12["step_s_median_loader_reading"],
          "phase13_step_s_median_loader_done":
              p12["step_s_median_loader_done"],
          "profile_same_batch": same_batch,
          "loader_wait_s": waits,
          "loader_wait_s_median": float(np.median(waits)),
          "losses": [r["loss"] for r in rows],
          "seconds": time.perf_counter() - t_phase})
    return half


def fused_adam_vs_unfused(dev, trainer):
    """One update (clip_grad_norm_, then the optimizer, as the train step
    runs them) of optimizer_conf.fused's Adam and of the unfused one, both
    from build_optimizer, from the same flagship weights and seeded grads
    (their norm past the clip) on the card → max abs difference of the
    parameters, and each update's time (CUDA events, 10 updates)."""
    from masr_tpu_torch.optimizer.schedulers import build_optimizer
    params = [p.detach().clone() for p in trainer.state.params]
    gen = torch.Generator(device=dev).manual_seed(0)
    grads = [torch.randn(p.shape, generator=gen, device=dev) * 0.01
             for p in params]
    out, ms = {}, {}
    for name in ("fused", "unfused"):
        ps = [torch.nn.Parameter(p.clone()) for p in params]
        for p, g in zip(ps, grads):
            p.grad = g.clone()
        opt = build_optimizer(ps, dict(
            optimizer="Adam", learning_rate=1e-3, weight_decay=1e-6,
            fused=name == "fused"))[0]

        def step():
            torch.nn.utils.clip_grad_norm_(ps, 5.0)
            opt.step()

        step()
        out[name] = [p.detach().clone() for p in ps]
        ms[name] = cuda_ms(step, iters=10)
    err = max(float((a - b).abs().max())
              for a, b in zip(out["fused"], out["unfused"]))
    return err, ms, float(torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(g) for g in grads])))


def phase_train_device_frontend(dev, half, smi):
    """The flagship with dataset_conf.on_device_frontend, optimizer_conf
    fused and manifest_type binary, trained 4 steps with the augmentation
    config (its specaug and specsub params drive the device frontend):
    the device fbank at dither 0 vs the host fbank on training utterances
    (FBANK_ATOL); one fused Adam update vs the unfused one on the card
    (ADAM_ATOL); the same launches per step as train_aug; the step wall
    median."""
    from masr_tpu_torch.audio import AudioSegment
    from masr_tpu_torch.data.audio_featurizer import AudioFeaturizer
    from masr_tpu_torch.ops.fbank import fbank_torch
    t_phase = time.perf_counter()
    root = os.path.join(WORK, "train_device_frontend")
    shutil.rmtree(root, ignore_errors=True)
    feat = AudioFeaturizer(**PREPROCESS)
    with open(half["test"], encoding="utf-8") as f:
        paths = [json.loads(l)["audio_filepath"] for l in f if l.strip()]
    fb_err = 0.0
    for path in paths:
        host = feat.featurize(AudioSegment.from_file(path))
        wav = feat.prepare_waveform(AudioSegment.from_file(path))
        dev_feats, n = fbank_torch(torch.from_numpy(wav).to(dev)[None],
                                   num_mel_bins=80, dither=0.0)
        check(int(n[0]) == host.shape[0], "device fbank frames == host's")
        fb_err = max(fb_err, float(np.abs(
            dev_feats[0].cpu().numpy() - host).max()))
    check(fb_err <= FBANK_ATOL, f"device fbank vs host {fb_err} <= "
          f"{FBANK_ATOL} ({len(paths)} utterances)")
    conf = train_config(half, root, 1)
    conf["dataset_conf"] = dict(conf["dataset_conf"], manifest_type="binary",
                                on_device_frontend=True)
    conf["optimizer_conf"] = dict(conf["optimizer_conf"], fused=True)
    rows, trainer = run_aug_train(dev, conf, half, root,
                                  "train_device_frontend")
    check(trainer.state.optimizer.defaults["fused"]
          and trainer.frontend is not None, "fused Adam and the device "
          "frontend in the trainer")
    check(trainer._setup_dataloader(True)[0]._reader is not None,
          "the training set reads the binary manifest")
    adam_err, adam_ms, g_norm = fused_adam_vs_unfused(dev, trainer)
    check(adam_err <= ADAM_ATOL, f"fused Adam vs unfused {adam_err} <= "
          f"{ADAM_ATOL}")
    emit({"phase": "train_device_frontend", "card": smi,
          "steps": len(rows), **step_times(rows),
          "loader_wait_s_median": float(np.median(
              [r["wait_s"] for r in rows[1:]])),
          "fbank_max_abs_err": fb_err, "fbank_atol": FBANK_ATOL,
          "fbank_utterances": len(paths),
          "fused_adam": {"max_abs_err": adam_err, "atol": ADAM_ATOL,
                         "grad_norm": g_norm, "clip": 5.0,
                         "step_ms": adam_ms},
          "losses": [r["loss"] for r in rows],
          "seconds": time.perf_counter() - t_phase})


# --------------------------------------------------------------------------- #
# bf16 serving of the Conformer (phases 44-47): rows 1, 2 and 5 in their
# bf16 modes (masr_tpu's compute dtype bf16), through InferencePredictor
# (dtype=torch.bfloat16) and BatchStreamSession
# --------------------------------------------------------------------------- #
BF16 = torch.bfloat16
PEAK_BF16_FLOPS = 989e12      # H100 SXM dense bf16 tensor cores
BF16_ROUNDING = 2.0 ** -8     # one bf16 rounding of a value, relative


def bf16_close(got, want, what):
    """A bf16 kernel vs its bf16 twin on the same card: both round the same
    operands at the same points and sum in f32 in other orders (and the
    kernels' attentions round unnormalised probabilities), so a rounding
    flips here and there. Max abs err <= 8 roundings of the largest output,
    mean abs err <= one rounding of the mean magnitude (the card tests'
    _assert_bf16_close). → max abs err."""
    check(got.dtype == want.dtype == BF16, f"bf16 outputs ({what})")
    got, want = got.float(), want.float()
    check(bool(torch.isfinite(got).all()), f"bf16 output finite ({what})")
    err = (got - want).abs()
    top = max(1.0, want.abs().max().item())
    mean = max(2 ** -4, want.abs().mean().item())
    check(err.max().item() <= 8 * BF16_ROUNDING * top, f"bf16 kernel vs "
          f"twin max abs err {err.max().item()} <= 8 roundings of {top} "
          f"({what})")
    check(err.mean().item() <= BF16_ROUNDING * mean, f"bf16 kernel vs twin "
          f"mean abs err {err.mean().item()} <= a rounding of {mean} "
          f"({what})")
    return err.max().item()


def reset_bf16_launches():
    from masr_tpu_torch.ops.cuda.chunk_layer import serving_product
    for fn in (layer_kernel("conformer"), chunk_kernel("conformer"),
               flash_kernel()):
        fn.bf16_launches = 0
    serving_product.launches = 0


def conformer_products(layers, static=False):
    """serving_product launches per bf16 Conformer encode of `layers`
    layers: the subsampling's, the CTC head's and each layer's linear_pos
    (a static-chunk model's eager layers: 11 each, as EFF_PRODUCTS')."""
    return 2 + (11 if static else 1) * layers


def product_launches():
    from masr_tpu_torch.ops.cuda.chunk_layer import serving_product
    return serving_product.launches


def _bound_bf16(flops, nbytes):
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_S
    return {"bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def _bf16_pack_bytes(layer):
    return sum(t.numel() * t.element_size()
               for t in layer.packed_params(BF16).values())


def layer_bound_bf16(layer, lens, T):
    """layer_bound's operations over the bf16 dense rate; bytes: the bf16
    pack (bf16 products, f32 rows), x in, out and pos_p in bf16."""
    D = layer.size
    f32 = layer_bound(layer, lens, T)
    nbytes = _bf16_pack_bytes(layer) + 2 * (2 * len(lens) * T * D + T * D)
    return _bound_bf16(f32["gflop"] * 1e9, nbytes)


def chunk_bound_bf16(layer, clens, active, c, C, pos_rows=None, rep=1):
    """chunk_bound's operations over the bf16 dense rate; its bytes with
    the bf16 pack and bf16 x, out, cache rows and position rows (pos_rows
    as chunk_bound's; rep the copies of each fresh ring row written)."""
    D, F, K = _widths(layer)
    B, M = len(clens), len(clens) * c
    if pos_rows is None:
        pos_rows = B * (C + c)
    n_act = sum(bool(a) for a in active)
    flops = chunk_bound(layer, clens, active, c, C)["gflop"] * 1e9
    nbytes = _bf16_pack_bytes(layer) + 2 * (
        2 * M * D + sum(clens) * 2 * D + n_act * min(c, C) * 2 * D * rep
        + pos_rows * D + (B + n_act) * (K - 1) * D)
    return _bound_bf16(flops, nbytes)


def flash_bound_bf16(mask, B, H, T, d):
    """flash_bound's visible-pair operations over the bf16 dense rate;
    bytes: q, k, v, out, p in bf16 and the mask, each once."""
    pairs = int(mask.sum())
    return _bound_bf16(6 * d * H * pairs,
                       2 * (4 * B * H * T * d + H * T * d) + B * T * T)


def products_ms(M, D, F_, dev, rows_pw1=None):
    """One torch.matmul (cuBLAS) bf16 call per product of a serving layer
    at its shapes, the library yardstick of rows 1 and 2 (timed here, used
    nowhere in the port): FFN w_1 and w_2 twice, q/k/v (N = 3D), out, pw1
    (over rows_pw1 rows, N = 2D), pw2. → CUDA-event ms of the eight."""
    g = torch.Generator().manual_seed(3)
    shapes = [(M, D, F_), (M, F_, D)] * 2 + [
        (M, D, 3 * D), (M, D, D), (rows_pw1 or M, D, 2 * D), (M, D, D)]
    pairs = [(torch.randn(m, k, generator=g).to(dev, BF16),
              torch.randn(k, n, generator=g).to(dev, BF16))
             for m, k, n in shapes]

    def run():
        return [a @ b for a, b in pairs]

    with torch.no_grad():
        return [cuda_ms(run), cuda_ms(run)]


def bf16_layer_args(layer, lens, T, seed, dev):
    x, lens_t, _ = layer_inputs(layer, lens, T, seed, dev)
    from masr_tpu_torch.models.embedding import sinusoid_position_encoding
    with torch.no_grad():
        pos_p = layer.self_attn.linear_pos(sinusoid_position_encoding(
            torch.arange(T, device=dev), layer.size).to(BF16))
    return x.to(BF16), lens_t, pos_p


def run_layer_bf16(fn, layer, x, lens, pos_p):
    # the main path's bf16 pack: bf16 products, f32 rows
    return fn(x, lens, pos_p, layer.chunk_packed_params(BF16),
              n_head=layer.attention_heads, ksize=layer.cnn_module_kernel,
              causal=layer.causal)


def bf16_chunk_args(layer, B, c, clens, wptrs, offsets, active, route,
                    seed, dev):
    """chunk_inputs in the bf16 mode: bf16 chunk, ring, cnn cache and
    positions (the bf16 table or linear_pos of the bf16 sinusoid), the
    layer's bf16 serving pack."""
    from masr_tpu_torch.models.embedding import sinusoid_position_encoding
    from masr_tpu_torch.ops.cuda import chunk_layer as ck
    x, _, starts, att, cnn, *ints, _ = chunk_inputs(
        layer, B, c, clens, wptrs, offsets, active, "exact", seed, dev)
    L = CACHE + c
    with torch.no_grad():
        if route == "table":
            pos = ck.make_chunk_pos_table(layer.self_attn.linear_pos.weight,
                                          CACHE, 8192, BF16)
            starts = ck.clamp_pos_starts(ints[2].new_tensor(offsets), 8192,
                                         L)
        else:
            rows = torch.clamp(torch.tensor(offsets, device=dev)[:, None]
                               - CACHE + torch.arange(L, device=dev), min=0)
            pos = layer.self_attn.linear_pos(sinusoid_position_encoding(
                rows.reshape(-1), layer.size).to(BF16))
    return (x.to(BF16), pos, starts, att.to(BF16), cnn.to(BF16), *ints,
            layer.chunk_packed_params(BF16))


def phase_bf16_kernels(dev, smi):
    """44. Rows 1, 2 and 5 in their bf16 modes vs their bf16 twins at the
    flagship width (the shapes of phases 2, 6 and 22), then each timed
    (CUDA events) beside its f32 kernel, its bf16 twin and the library:
    torch.matmul bf16 of the layer's products (rows 1, 2), SDPA bf16
    (row 5). → {row: numbers for the kernels line}."""
    import torch.nn.functional as F
    from masr_tpu_torch.ops.cuda import chunk_layer as ck
    from masr_tpu_torch.ops.cuda import conformer_layer as cl
    from masr_tpu_torch.ops.cuda import rel_pos_attention as rpa
    out, cases = {}, {"row1": [], "row2": [], "row5": []}
    # row 1: T' 37, 299, 1500, B=4 ragged, causal and not
    worst1 = 0.0
    for T in (37, 299, 1500):
        lens = [T, T - 17, 5, 0]
        for causal in (True, False):
            layer = seeded_layer(T, causal, dev)
            x, lens_t, pos_p = bf16_layer_args(layer, lens, T, T + 1, dev)
            with torch.no_grad():
                got = run_layer_bf16(cl.fused_conformer_layer, layer, x,
                                     lens_t, pos_p)
                want = run_layer_bf16(cl.fused_conformer_layer_plain, layer,
                                      x, lens_t, pos_p)
            torch.cuda.synchronize()
            what = f"row 1 bf16, T'={T}, causal={causal}"
            err = max(bf16_close(got[b, :n], want[b, :n], what)
                      for b, n in enumerate(lens) if n)
            bits = utterance_bits_match(
                lambda m, *a: run_layer_bf16(cl.fused_conformer_layer, m,
                                             *a),
                layer, x, lens_t, pos_p, got, what) if T == 299 else 0
            cases["row1"].append({"T": T, "causal": causal,
                                  "max_abs_err": err, "b1_bits_equal": bits})
            worst1 = max(worst1, err)
    # row 2: the engine's 32 slots (table, exact, two sub-chunks) and one
    worst2 = 0.0
    layer = seeded_layer(11, True, dev)
    for B, c, n_sub, route in ((32, 16, 1, "table"), (32, 16, 1, "exact"),
                               (32, 32, 2, "table"), (1, 16, 1, "exact")):
        clens = [(0, 5, 100, CACHE)[s % 4] for s in range(B)]
        wptrs = [(37 * s) % CACHE for s in range(B)]
        offsets = [n + 16 * s if n else 0 for s, n in enumerate(clens)]
        active = [0 if s in (3, 10, 17, 29) else 1 for s in range(B)]
        args = bf16_chunk_args(layer, B, c, clens, wptrs, offsets, active,
                               route, B + c, dev)
        att0, cnn0 = args[3], args[4]
        with torch.no_grad():
            res = {}
            for name, fn in (("kernel", ck.fused_chunk_layer),
                             ("plain", ck.fused_chunk_layer_plain)):
                a = args[:3] + (att0.clone(), cnn0.clone()) + args[5:]
                res[name] = (run_chunk(fn, layer, a, n_sub), a[3], a[4])
        torch.cuda.synchronize()
        what = f"row 2 bf16, B={B}, c={c}, n_sub={n_sub}, {route}"
        on = torch.tensor(active, device=dev) == 1
        err = max(bf16_close(res["kernel"][0], res["plain"][0], what),
                  bf16_close(res["kernel"][1][on], res["plain"][1][on],
                             what + ", ring"),
                  bf16_close(res["kernel"][2][on], res["plain"][2][on],
                             what + ", cnn cache"))
        check(torch.equal(res["kernel"][1][~on], att0[~on])
              and torch.equal(res["kernel"][2][~on], cnn0[~on]),
              f"inactive slots' bf16 caches bitwise unchanged ({what})")
        bits = slot_bits_match(
            lambda a: run_chunk(ck.fused_chunk_layer, layer, a, n_sub),
            args, CACHE + c if route == "exact" else None) if B > 1 else 0
        cases["row2"].append({"B": B, "c": c, "n_sub": n_sub,
                              "route": route, "inactive": int((~on).sum()),
                              "max_abs_err": err,
                              "b1_bits_equal_slots": bits})
        worst2 = max(worst2, err)
    # row 5: masks of the static-chunk path and random ones
    worst5 = 0.0
    for T, d in ((37, 64), (299, 64), (1500, 64), (299, 32), (299, 128)):
        lens = [T, T - 17, max(T // 3, 1), 0]
        for kind in ("full", "static16", "random"):
            mask = flash_mask(kind, lens, T, dev)
            args = tuple(t.to(BF16) for t in
                         flash_inputs(4, T, d, T + d, dev))
            with torch.no_grad():
                got = rpa.rel_pos_flash_attention(*args, mask)
                want = rpa.rel_pos_attention_plain(*args, mask)
            torch.cuda.synchronize()
            what = f"row 5 bf16, {kind}, T'={T}, d_k={d}"
            err = bf16_close(got, want, what)
            empty = ~mask.any(-1)
            check(bool((got.transpose(1, 2)[empty] == 0).all()),
                  f"rows with no visible key exactly 0 ({what})")
            cases["row5"].append({"T": T, "d_k": d, "mask": kind,
                                  "max_abs_err": err})
            worst5 = max(worst5, err)
    # times at the main paths' shapes
    times = {}
    T, lens = 299, [299] * 8
    layer = seeded_layer(7, True, dev)
    x32, lens_t, pos32 = layer_inputs(layer, lens, T, 8, dev)
    x, _, pos_p = bf16_layer_args(layer, lens, T, 8, dev)
    with torch.no_grad():
        runs = alternate(
            lambda: run_layer_bf16(cl.fused_conformer_layer, layer, x,
                                   lens_t, pos_p),
            lambda: run_layer(cl.fused_conformer_layer, layer, x32, lens_t,
                              pos32))
        plain = [cuda_ms(lambda: run_layer_bf16(
            cl.fused_conformer_layer_plain, layer, x, lens_t, pos_p), 5)]
        err = bf16_close(run_layer_bf16(cl.fused_conformer_layer, layer, x,
                                        lens_t, pos_p),
                         run_layer_bf16(cl.fused_conformer_layer_plain,
                                        layer, x, lens_t, pos_p),
                         "row 1 bf16, timed shape")
    lib = products_ms(8 * T, 256, 2048, dev)
    times["row1"] = {"B": 8, "T": T, "bf16_ms": runs["kernel"],
                     "f32_ms": runs["plain"], "bf16_plain_ms": plain,
                     "matmul_bf16_ms": lib, "max_abs_err": err,
                     **layer_bound_bf16(layer, lens, T)}
    out["row1"] = {"ms": float(np.mean(runs["kernel"])),
                   "plain_ms": plain[0], "library_ms": float(np.mean(lib)),
                   "max_abs_err": max(worst1, err),
                   **layer_bound_bf16(layer, lens, T)}
    B = ENGINE_STREAMS
    layer = seeded_layer(13, True, dev)
    clens, active = [CACHE] * B, [1] * B
    wp, offs = [(37 * s) % CACHE for s in range(B)], [CACHE + 64 * s
                                                       for s in range(B)]
    args = bf16_chunk_args(layer, B, CHUNK, clens, wp, offs, active, "table",
                           5, dev)
    args32 = chunk_inputs(layer, B, CHUNK, clens, wp, offs, active, "table",
                          5, dev)
    with torch.no_grad():
        runs = alternate(
            lambda: run_chunk(ck.fused_chunk_layer, layer, args),
            lambda: run_chunk(ck.fused_chunk_layer, layer, args32))
        plain = [cuda_ms(lambda: run_chunk(ck.fused_chunk_layer_plain, layer,
                                           args), 5)]
    lib = products_ms(B * CHUNK, 256, 2048, dev,
                      rows_pw1=B * (layer.cnn_module_kernel - 1 + CHUNK))
    bound = chunk_bound_bf16(layer, clens, active, CHUNK, CACHE,
                             pos_rows=window_rows(args[2], CACHE + CHUNK))
    times["row2"] = {"B": B, "c": CHUNK, "C": CACHE,
                     "bf16_ms": runs["kernel"], "f32_ms": runs["plain"],
                     "bf16_plain_ms": plain, "matmul_bf16_ms": lib, **bound}
    out["row2"] = {"ms": float(np.mean(runs["kernel"])),
                   "plain_ms": plain[0], "library_ms": float(np.mean(lib)),
                   "max_abs_err": worst2, **bound}
    B, H, d, T = 8, 4, 64, 1500
    lens = [int(n) for n in np.linspace(T, round(0.533 * T), B).round()]
    mask = flash_mask("static16", lens, T, dev)
    args32 = flash_inputs(B, T, d, 40 + T, dev)
    args = tuple(t.to(BF16) for t in args32)
    q, k, v, p, bu, bv = args
    q_cat = torch.cat([q + bu[None, :, None], q + bv[None, :, None]], dim=-1)
    k_cat = torch.cat([k, p[None].expand(B, -1, -1, -1)], dim=-1)
    with torch.no_grad():
        err = bf16_close(rpa.rel_pos_flash_attention(*args, mask),
                         rpa.rel_pos_attention_plain(*args, mask),
                         "row 5 bf16, timed shape")
        runs = alternate(lambda: rpa.rel_pos_flash_attention(*args, mask),
                         lambda: rpa.rel_pos_flash_attention(*args32, mask))
        plain = [cuda_ms(lambda: rpa.rel_pos_attention_plain(*args, mask),
                         5)]

        def library():
            return F.scaled_dot_product_attention(
                q_cat, k_cat, v, attn_mask=mask[:, None],
                scale=1.0 / d ** 0.5)
        lib = [cuda_ms(library), cuda_ms(library)]
        backend = sdpa_backend(library)
    times["row5"] = {"B": B, "T": T, "lens": lens, "mask": "static chunk 16",
                     "bf16_ms": runs["kernel"], "f32_ms": runs["plain"],
                     "bf16_plain_ms": plain, "sdpa_bf16_ms": lib,
                     "sdpa_backend": backend, "max_abs_err": err,
                     **flash_bound_bf16(mask, B, H, T, d)}
    out["row5"] = {"ms": float(np.mean(runs["kernel"])),
                   "plain_ms": plain[0], "library_ms": float(np.mean(lib)),
                   "max_abs_err": max(worst5, err),
                   **flash_bound_bf16(mask, B, H, T, d)}
    times["row5_sweep"] = flash_sweep_bf16(dev)
    out["row5"]["max_abs_err"] = max(
        out["row5"]["max_abs_err"],
        max(v["max_abs_err"] for v in times["row5_sweep"]))
    out["product"], cases["product"], times["product"] = \
        bf16_product_kernel(dev)
    emit({"phase": "bf16_kernels", "card": smi,
          "rule": "max abs err <= 8 bf16 roundings (2^-8) of the largest "
                  "output, mean <= one of the mean magnitude",
          "cases": cases, "times": times})
    return out


def flash_sweep_bf16(dev):
    """Row 5's bf16 kernel over FLASH_SWEEP_T at B=8, 4 heads, d_k 64 under
    the static-16 mask with lengths T' down to 0.53 T' (phase 24's
    inputs, rounded to bf16): vs its bf16 twin (bf16_close), CUDA-event
    times of the kernel and of SDPA bf16 on the same [q+u | q+v], [k | p],
    v and mask (twice each, in turns), the bound. → one dict a T'."""
    import torch.nn.functional as F
    from masr_tpu_torch.ops.cuda import rel_pos_attention as rpa
    B, H, d = 8, 4, 64
    rows = []
    for T in FLASH_SWEEP_T:
        lens = [int(n) for n in
                np.linspace(T, round(0.533 * T), B).round().astype(int)]
        mask = flash_mask("static16", lens, T, dev)
        args = tuple(t.to(BF16) for t in flash_inputs(B, T, d, 40 + T, dev))
        q, k, v, p, bu, bv = args
        q_cat = torch.cat([q + bu[None, :, None], q + bv[None, :, None]],
                          dim=-1)
        k_cat = torch.cat([k, p[None].expand(B, -1, -1, -1)], dim=-1)

        def kernel(args=args, mask=mask):
            return rpa.rel_pos_flash_attention(*args, mask)

        def library(q_cat=q_cat, k_cat=k_cat, v=v, mask=mask):
            return F.scaled_dot_product_attention(
                q_cat, k_cat, v, attn_mask=mask[:, None],
                scale=1.0 / d ** 0.5)

        with torch.no_grad():
            err = bf16_close(kernel(), rpa.rel_pos_attention_plain(
                *args, mask), f"row 5 bf16 sweep, T'={T}")
            kms, lms = [cuda_ms(kernel)], [cuda_ms(library)]
            lms.append(cuda_ms(library))
            kms.append(cuda_ms(kernel))
        rows.append({"T": T, "lens": lens, "bf16_ms": kms,
                     "sdpa_bf16_ms": lms, "max_abs_err": err,
                     **flash_bound_bf16(mask, B, H, T, d)})
    return rows


def bf16_product_kernel(dev):
    """The subsampling's bf16 output product (serving_product, K = 256 x 19
    = 4864, N = 256) against its twin at the main paths' rows: 32 windows
    of 16 (the engine's dispatch), one window, 8 utterances of 299 frames;
    every window's (utterance's) bits from a call of its own rows equal
    its rows of the batched call; timed at 32 windows beside its twin and
    torch.matmul bf16 (cuBLAS, the call it replaces). → (kernels-line
    numbers, cases, times)."""
    from masr_tpu_torch.ops.cuda.chunk_layer import (serving_product,
                                                     serving_product_plain)
    K, N = 256 * 19, 256
    g = torch.Generator().manual_seed(44)
    w = (torch.randn(K, N, generator=g) / K ** 0.5).to(dev, BF16)
    cases, worst = [], 0.0
    for B, T in ((32, CHUNK), (1, CHUNK), (8, 299)):
        x = torch.relu(torch.randn(B, T, K, generator=g)).to(dev, BF16)
        with torch.no_grad():
            got = serving_product(x, w)
            err = bf16_close(got, serving_product_plain(x, w),
                             f"serving product bf16, {B} x {T} rows")
            for b in range(B if B > 1 else 0):
                check(torch.equal(serving_product(x[b:b + 1], w),
                                  got[b:b + 1]),
                      f"serving product: block {b}'s bits alone == its rows "
                      f"of the {B} x {T} call")
        cases.append({"B": B, "T": T, "max_abs_err": err,
                      "b1_bits_equal": B if B > 1 else 0})
        worst = max(worst, err)
    B, T = ENGINE_STREAMS, CHUNK
    x = torch.relu(torch.randn(B, T, K, generator=g)).to(dev, BF16)
    M = B * T
    with torch.no_grad():
        runs = alternate(lambda: serving_product(x, w),
                         lambda: serving_product_plain(x, w))
        lib = [cuda_ms(lambda: x @ w), cuda_ms(lambda: x @ w)]
    bound = _bound_bf16(2 * M * N * K, 2 * (M * K + K * N + M * N))
    times = {"M": M, "N": N, "K": K, "bf16_ms": runs["kernel"],
             "bf16_plain_ms": runs["plain"], "matmul_bf16_ms": lib, **bound}
    return ({"ms": float(np.mean(runs["kernel"])),
             "plain_ms": float(np.mean(runs["plain"])),
             "library_ms": float(np.mean(lib)), "max_abs_err": worst,
             **bound}, cases, times)


def bf16_predictor(path, dev, **kw):
    """A MASRPredictor (host featurizer, greedy decoding, predict_stream)
    whose InferencePredictor is the bf16 one, InferencePredictor(path,
    dtype=torch.bfloat16): masr_tpu's bf16 serving entry point (its
    MASRPredictor, as the port's, takes no dtype)."""
    from masr_tpu_torch.infer.inference_model import InferencePredictor
    from masr_tpu_torch.infer.predictor import MASRPredictor
    pred = MASRPredictor(model_dir=path, device=dev, warmup=False, **kw)
    pred.predictor = InferencePredictor(path, device=dev, dtype=BF16)
    return pred


def bf16_probs_vs_cpu(ip, path, speech, lens, f32_probs, what):
    """The card's bf16 probs against the CPU's bf16 twin route on the same
    features, each against the card's f32 probs: the card's bf16 route
    may stray from f32 at most twice as far as the CPU's (max abs over the
    valid frames; the two bf16 routes round alike and sum in other orders,
    while a kernel fault moves probs far past bf16's distance), and no
    argmax flips between the two bf16 routes where the CPU's top-2 margin
    exceeds that bound. → (max abs err card vs CPU, the CPU's bf16
    distance from f32, the card's, frames compared)."""
    from masr_tpu_torch.infer.inference_model import InferencePredictor
    p_gpu, l_gpu = ip.predict(speech, lens)
    cpu = InferencePredictor(path, device="cpu", dtype=BF16)
    p_cpu, l_cpu = cpu.predict(speech, lens)
    check((l_gpu == l_cpu).all() and p_gpu.shape == p_cpu.shape,
          f"bf16 probs shape and lengths card == CPU ({what})")
    check(np.isfinite(p_gpu).all() and p_gpu.dtype == np.float32,
          f"bf16 probs finite f32 ({what})")
    err = d_cpu = d_card = 0.0
    for b, n in enumerate(l_cpu):
        g, c, f = p_gpu[b, :n], p_cpu[b, :n], f32_probs[b, :n]
        err = max(err, float(np.abs(g - c).max()))
        d_cpu = max(d_cpu, float(np.abs(c - f).max()))
        d_card = max(d_card, float(np.abs(g - f).max()))
    check(d_card <= 2 * d_cpu, f"the card's bf16 probs {d_card} from f32 <= "
          f"twice the CPU bf16 route's {d_cpu} ({what})")
    compared = 0
    for b, n in enumerate(l_cpu):
        top2 = np.sort(p_cpu[b, :n], axis=-1)[:, -2:]
        sure = top2[:, 1] - top2[:, 0] > 2 * d_cpu
        flips = int((p_gpu[b, :n].argmax(-1)
                     != p_cpu[b, :n].argmax(-1))[sure].sum())
        check(flips == 0, f"{flips} argmax flips past a top-2 margin of "
              f"{2 * d_cpu} ({what})")
        compared += int(sure.sum())
    return err, d_cpu, d_card, compared


def phase_bf16_offline(dev, gpu, wavs):
    """45. The seeded flagship (phase 3's bundle) read by
    InferencePredictor(dtype=bf16): predict of the 8 utterances launches
    row 1's bf16 mode once per layer (no other row, no f32 launch) and the
    bf16 products (conformer_products), probs vs the CPU's bf16 twin route;
    walls beside f32; the example bundle's held-out sentences read at bf16
    against f32. → the main path's bf16 launches."""
    from masr_tpu_torch.infer.inference_model import InferencePredictor
    path = gpu.model_dir
    speech, lens = gpu.featurize_batch(wavs)
    ip = InferencePredictor(path, device=dev, dtype=BF16)
    ip.predict(speech[:1], lens[:1])                      # warm
    reset_launches()
    reset_bf16_launches()
    t0 = time.perf_counter()
    ip.predict(speech, lens)
    first = time.perf_counter() - t0
    fn = layer_kernel("conformer")
    launches = (fn.launches, fn.bf16_launches, flash_kernel().launches,
                chunk_kernel("conformer").launches, product_launches())
    n = FLAGSHIP_ENCODER["num_blocks"]
    want = (n, n, 0, 0, conformer_products(n))
    check(launches == want, f"bf16 predict launches {launches} == {want}: "
          "row 1 (all bf16), flash, chunk, the products (the subsampling's, "
          "the head's, linear_pos)")
    p32, _ = gpu.predictor.predict(speech, lens)
    err, dist, d_card, compared = bf16_probs_vs_cpu(ip, path, speech, lens,
                                                    p32, "flagship")
    walls = {"bf16": [], "f32": []}
    for _ in range(3):
        for name, pred in (("bf16", ip), ("f32", gpu.predictor)):
            t0 = time.perf_counter()
            pred.predict(speech, lens)
            walls[name].append(time.perf_counter() - t0)
    from masr_tpu_torch.audio.synth_tts import SyntheticTTS
    from masr_tpu_torch.infer.predictor import MASRPredictor
    tts = SyntheticTTS(sample_rate=16000)
    f32 = MASRPredictor(model_dir=TINY_BUNDLE, device=dev, warmup=False)
    bf = bf16_predictor(TINY_BUNDLE, dev)
    rows = []
    for text, spk in HELD_OUT:
        wav = tts.render(text, spk_id=spk)
        reset_bf16_launches()
        got = bf.predict(wav)["text"]
        check((layer_kernel("conformer").bf16_launches,
               product_launches()) == (2, conformer_products(2)),
              "example bundle bf16: 2 row-1 bf16 launches and "
              f"{conformer_products(2)} product launches per predict")
        rows.append((text, got, f32.predict(wav)["text"]))
    exact = sum(want == got for want, got, _ in rows)
    check(exact >= 2, f"example bundle at bf16 read {exact}/3 held-out "
          "sentences")
    emit({"phase": "bf16_offline", "launches": launches[1],
          "probs_max_abs_err_card_vs_cpu": err,
          "probs_cpu_bf16_vs_f32_max_abs": dist,
          "probs_card_bf16_vs_f32_max_abs": d_card,
          "argmax_frames_compared": compared,
          "predict_s": walls, "first_predict_s": first,
          "example_bundle": {"exact": exact, "of": len(rows),
                             "texts_equal_f32": sum(g == f for _, g, f
                                                    in rows),
                             "texts": [g for _, g, _ in rows]}})
    return launches[1]


def phase_bf16_stream(dev, path, wavs, smi):
    """46. chunk_step and BatchStreamSession(max_streams=32) in bf16 on the
    flagship stream bundle: each single stream (InferencePredictor bf16
    under predict_stream, host frontend) launches row 2's bf16 mode 12
    times a window and conformer_products(12) products (exact positions);
    the 32-stream engine 12 bf16 launches and two products per dispatch
    (the subsampling's, the head's: the position tables), its texts == the
    single streams' (the top-2 margin rule, ARGMAX_MARGIN: every bf16 part
    of a window's path gives a window's bits alone as in the batch); the
    trained example bundle's 8 engine streams == its single streams'; the
    fused frontend whole == in 0.2 s pieces; window latency at B=1 and the
    engine tick at 32 slots in bf16, beside f32's. → (the engine's bf16
    launches, its product launches), and the ticks and windows by
    dtype."""
    from masr_tpu_torch.infer.batch_stream import BatchStreamSession
    n = CHUNK_LAUNCHES["conformer"]
    one = bf16_predictor(path, dev, fused_frontend=False)
    check(one.predictor.model.encoder.compute_dtype == BF16, "bf16 model")
    refs = []
    for w in wavs:
        reset_bf16_launches()
        got = stream(one, w)
        # predict_stream's windows take exact positions: linear_pos of
        # every layer besides the subsampling's and the head's products
        check((chunk_kernel("conformer").bf16_launches, product_launches())
              == (n * got["windows"], conformer_products(n) * got["windows"]),
              f"bf16 chunk and product launches == {n} and "
              f"{conformer_products(n)} x {got['windows']} windows")
        refs.append(got)
    fused = bf16_predictor(path, dev)
    whole, pieces = stream(fused, wavs[3]), stream(fused, wavs[3], PIECE)
    check(whole["text"] == pieces["text"] and bool(whole["text"]),
          "bf16 fused frontend: whole == 0.2 s pieces, not empty")
    sess = BatchStreamSession(
        one.predictor, one._vocab_list, max_streams=ENGINE_STREAMS,
        preprocess_conf=one.predictor.meta["preprocess_conf"])
    check(sess.states["att_cache"].dtype == BF16
          and sess.states["cnn_cache"].dtype == BF16, "bf16 slot state")
    orig, dispatches = sess._dispatch, []
    top2 = {s: [] for s in range(ENGINE_STREAMS)}

    def spy(xs, active, valids, exact):
        rec = []
        with record_top2(rec):
            res = orig(xs, active, valids, exact)
        for slot, k in valids.items():
            top2[slot].append(rec[0][slot, :k])
        dispatches.append(int(np.sum(active)))
        return res

    sess._dispatch = spy
    streams = [wavs[k % len(wavs)] for k in range(ENGINE_STREAMS)]
    slots = [sess.open() for _ in streams]
    late = [3 * (k % 8) + k // 8 for k in range(len(streams))]
    texts = [None] * len(streams)
    # the main path: counts read around the engine run alone
    reset_launches()
    reset_bf16_launches()
    t0 = time.perf_counter()
    for i in range(max(len(w) // PIECE + 1 + d
                       for w, d in zip(streams, late))):
        items = [(s, w[(i - d) * PIECE:(i - d + 1) * PIECE],
                  (i - d + 1) * PIECE >= len(w))
                 for s, w, d in zip(slots, streams, late)
                 if 0 <= i - d and (i - d) * PIECE < len(w)]
        if items:
            for s, r in sess.feed_many(items).items():
                if r is not None:
                    texts[slots.index(s)] = r["text"]
    wall = time.perf_counter() - t0
    fn = chunk_kernel("conformer")
    launches = (fn.launches, fn.bf16_launches, product_launches())
    check(launches == (n * len(dispatches),) * 2 + (2 * len(dispatches),),
          f"engine launches {launches} == {n} x {len(dispatches)} "
          "dispatches, all bf16, and two products a dispatch")
    got = [{"text": t, "ids": np.asarray(sess._decoders[s]._max_index),
            "top2": np.concatenate(top2[s])} for s, t in zip(slots, texts)]
    margins = [same_text(g, refs[k % len(wavs)], f"bf16 engine stream {k}")
               for k, g in enumerate(got)]
    for s in slots:
        sess.close(s)
    # the trained example bundle (confident frames): 8 streams of its
    # held-out sentences, texts against the single streams'
    from masr_tpu_torch.audio.synth_tts import SyntheticTTS
    tts = SyntheticTTS(sample_rate=16000)
    rs = np.random.RandomState(0)
    held = [w + 1e-3 * rs.standard_normal(len(w)).astype(np.float32)
            for w in (tts.render(t, spk_id=k) for t, k in HELD_OUT)]
    tiny = bf16_predictor(TINY_BUNDLE, dev, fused_frontend=False)
    tiny_refs = [stream(tiny, w)["text"] for w in held]
    tsess = BatchStreamSession(
        tiny.predictor, tiny._vocab_list, max_streams=8,
        preprocess_conf=tiny.predictor.meta["preprocess_conf"])
    tslots = [tsess.open() for _ in range(8)]
    ttexts = {}
    for i in range(max(len(w) for w in held) // PIECE + 1):
        items = [(s, held[k % 3][i * PIECE:(i + 1) * PIECE],
                  (i + 1) * PIECE >= len(held[k % 3]))
                 for k, s in enumerate(tslots)
                 if i * PIECE < len(held[k % 3])]
        for s, r in tsess.feed_many(items).items():
            if r is not None:
                ttexts[s] = r["text"]
    tiny_equal = sum(ttexts.get(s) == tiny_refs[k % 3]
                     for k, s in enumerate(tslots))
    check(tiny_equal == 8, f"example bundle bf16 engine texts == single "
          f"streams' ({tiny_equal} of 8)")
    # the tick and the window beside f32's in this phase, in the order f32,
    # bf16, bf16, f32 (the card machine's host runs slower late in a run)
    engine, window = {"f32": [], "bf16": []}, {"f32": [], "bf16": []}
    for name in ("f32", "bf16", "bf16", "f32"):
        dt = BF16 if name == "bf16" else None
        tick = engine_tick(dev, path, wavs, ENGINE_STREAMS, dtype=dt)
        engine[name].append({k: tick[k] for k in ("tick_s_median",
                                                  "dispatch_s_median",
                                                  "x_real_time")})
        win = window_latency(dev, path, wavs, dtype=dt)
        window[name].append({k: win[k] for k in ("p50_s", "p90_s")})
    emit({"phase": "bf16_stream", "card": smi, "streams": ENGINE_STREAMS,
          "dispatches": len(dispatches), "launches": launches[1],
          "texts_equal_single_stream": sum(m is None for m in margins),
          "example_bundle_engine_texts_equal": tiny_equal,
          "parted_margins": [m for m in margins if m is not None],
          "single_stream_windows": sum(r["windows"] for r in refs),
          "engine_wall_s": wall, "engine": engine, "predict_stream": window})
    return launches[1:], engine, window


def phase_bf16_static(dev, static_gpu, wavs, long):
    """47. The static-chunk flagship (phase 23's bundle) read at bf16:
    predict_batch-shaped encodes of the 8 utterances and of the 4 long
    ones launch row 5's bf16 mode once per layer (no row 1); probs of two
    utterances vs the CPU's bf16 twin route. → the main path's bf16
    launches."""
    from masr_tpu_torch.infer.inference_model import InferencePredictor
    path = static_gpu.model_dir
    ip = InferencePredictor(path, device=dev, dtype=BF16)
    n = FLAGSHIP_ENCODER["num_blocks"]
    runs = {}
    for name, batch in (("batch", wavs), ("long_batch", long)):
        speech, lens = static_gpu.featurize_batch(batch)
        # the main path: counts read around the encode alone
        reset_launches()
        reset_bf16_launches()
        t0 = time.perf_counter()
        probs, out_lens = ip.predict(speech, lens)
        wall = time.perf_counter() - t0
        got = (flash_kernel().launches, flash_kernel().bf16_launches,
               layer_kernel("conformer").launches, product_launches())
        want = (n, n, 0, conformer_products(n, static=True))
        check(got == want, f"bf16 static launches {got} == {want}: flash "
              f"(all bf16), row 1, the products ({name})")
        check(np.isfinite(probs).all(), f"bf16 static probs finite ({name})")
        runs[name] = {"utterances": len(batch), "T_out": int(probs.shape[1]),
                      "launches": got[1], "predict_s": wall}
    speech, lens = static_gpu.featurize_batch(wavs[:2])
    p32, _ = static_gpu.predictor.predict(speech, lens)
    err, dist, d_card, compared = bf16_probs_vs_cpu(ip, path, speech, lens,
                                                    p32, "static chunk")
    emit({"phase": "bf16_static", **runs,
          "probs_max_abs_err_card_vs_cpu": err,
          "probs_cpu_bf16_vs_f32_max_abs": dist,
          "probs_card_bf16_vs_f32_max_abs": d_card,
          "argmax_frames_compared": compared})
    return runs["batch"]["launches"]


# --------------------------------------------------------------------------- #
# bf16 serving of the Squeezeformer, the Efficient-Conformer and DeepSpeech2
# (phases 48-51): rows 6 and 8 in their bf16 modes, and each family through
# InferencePredictor(dtype=torch.bfloat16) and BatchStreamSession
# --------------------------------------------------------------------------- #
# serving_product launches (every bf16 Linear and pointwise conv, models/
# layers.py) per Squeezeformer encode or window in bf16: the subsampling's
# input_proj, linear_pos of every layer, the time reduction's pointwise conv
# and the recover linear (one reduce and one recover), the CTC head
SQ_PRODUCTS = 1 + SQ_ENCODER["num_blocks"] + 2 + 1
# per Efficient-Conformer encode: the subsampling's and the head's, 11 in
# each eager head layer (the FFNs' 4, q, k, v, out, linear_pos, the conv
# module's 2 pointwise), linear_pos in each tail layer; per eager window 11
# in every layer and the two
EFF_PRODUCTS = (2 + 11 * (12 - EFF_TAIL) + EFF_TAIL, 2 + 11 * 12)


def reset_family_bf16_launches():
    for fn in (layer_kernel("squeezeformer"), chunk_kernel("squeezeformer")):
        fn.bf16_launches = 0
    reset_bf16_launches()


def run_sq_layer_bf16(fn, layer, x, lens, pos_p):
    # the main path's bf16 pack: unfolded adaptive scales, bf16 products
    return fn(x, lens, pos_p, layer.chunk_packed_params(BF16),
              n_head=layer.attention_heads, ksize=layer.cnn_module_kernel,
              causal=layer.causal, conv_ln=layer.conv_ln)


def sq_chunk_args_bf16(layer, B, c, C, rep, clens, wptrs, offsets, active,
                       seed, dev):
    """sq_chunk_inputs in the bf16 mode: bf16 chunk, positions, cnn cache
    and full-resolution ring (each half-rate row's copies equal, as the
    encoder keeps them), the layer's bf16 serving pack."""
    x, pos, starts, att, cnn, *ints, _ = sq_chunk_inputs(
        layer, B, c, C, rep, clens, wptrs, offsets, active, seed, dev)
    att = att[:, :, rep - 1::rep].repeat_interleave(rep, dim=2)
    return (x.to(BF16), pos.to(BF16), starts, att.to(BF16), cnn.to(BF16),
            *ints, layer.chunk_packed_params(BF16))


def phase_bf16_sq_kernels(dev, smi):
    """48. Rows 6 and 8 in their bf16 modes vs their bf16 twins at phase
    14's shapes, then timed at the main paths' shapes (CUDA events) beside
    their f32 kernels, their bf16 twins and torch.matmul bf16 of their
    products. → {row: numbers for the kernels line}."""
    from masr_tpu_torch.ops.cuda import chunk_layer_sq as cks
    from masr_tpu_torch.ops.cuda import squeezeformer_layer as sq
    out, cases = {}, {"row6": [], "row8": []}
    worst6 = 0.0
    for T in (150, 299):
        lens = [T, T - 17, 5, 0]
        for conv_norm, causal in (("batch_norm", True), ("layer_norm", True),
                                  ("batch_norm", False)):
            layer = seeded_sq_layer(T + causal, causal, conv_norm, dev)
            x, lens_t, pos_p = bf16_layer_args(layer, lens, T, T + 2, dev)
            with torch.no_grad():
                got = run_sq_layer_bf16(sq.fused_squeezeformer_layer, layer,
                                        x, lens_t, pos_p)
                want = run_sq_layer_bf16(sq.fused_squeezeformer_layer_plain,
                                         layer, x, lens_t, pos_p)
            torch.cuda.synchronize()
            what = f"row 6 bf16, T'={T}, {conv_norm}, causal={causal}"
            err = max(bf16_close(got[b, :n], want[b, :n], what)
                      for b, n in enumerate(lens) if n)
            bits = utterance_bits_match(
                lambda m, *a: run_sq_layer_bf16(sq.fused_squeezeformer_layer,
                                                m, *a),
                layer, x, lens_t, pos_p, got, what) if T == 299 else 0
            cases["row6"].append({"T": T, "conv_norm": conv_norm,
                                  "causal": causal, "max_abs_err": err,
                                  "b1_bits_equal": bits})
            worst6 = max(worst6, err)
    worst8 = 0.0
    for B, rep, n_sub in ((32, 1, 1), (32, 2, 1), (32, 1, 2), (1, 1, 1),
                          (1, 2, 1)):
        c, C, clens, wptrs, offsets, active = sq_chunk_case(B, rep, n_sub)
        layer = seeded_sq_layer(70 + B + rep, True, "batch_norm", dev)
        args = sq_chunk_args_bf16(layer, B, c, C, rep, clens, wptrs, offsets,
                                  active, B + c, dev)
        att0, cnn0 = args[3], args[4]
        with torch.no_grad():
            res = {}
            for name, fn in (("kernel", cks.fused_chunk_layer_sq),
                             ("plain", cks.fused_chunk_layer_sq_plain)):
                a = args[:3] + (att0.clone(), cnn0.clone()) + args[5:]
                res[name] = (run_sq_chunk(fn, layer, a, n_sub, rep), a[3],
                             a[4])
        torch.cuda.synchronize()
        what = f"row 8 bf16, B={B}, c={c}, C={C}, rep={rep}, n_sub={n_sub}"
        on = torch.tensor(active, device=dev) == 1
        (y, att_k, cnn_k), (y_p, att_p, cnn_p) = res["kernel"], res["plain"]
        err = max(bf16_close(y, y_p, what),
                  bf16_close(att_k[on], att_p[on], what + ", ring"),
                  bf16_close(cnn_k[on], cnn_p[on], what + ", cnn cache"))
        check(torch.equal(att_k[~on], att0[~on])
              and torch.equal(cnn_k[~on], cnn0[~on]),
              f"inactive slots' bf16 caches bitwise unchanged ({what})")
        check(rep == 1 or torch.equal(att_k[:, :, 0::2], att_k[:, :, 1::2]),
              f"every half-rate ring row's two copies equal ({what})")
        bits = slot_bits_match(
            lambda a: run_sq_chunk(cks.fused_chunk_layer_sq, layer, a, n_sub,
                                   rep), args, C + c) if B > 1 else 0
        cases["row8"].append({"B": B, "c": c, "C": C, "rep": rep,
                              "n_sub": n_sub, "inactive": int((~on).sum()),
                              "max_abs_err": err,
                              "b1_bits_equal_slots": bits})
        worst8 = max(worst8, err)
    times = {}
    for T in (299, 150):
        lens = [T] * 8
        layer = seeded_sq_layer(50 + T, True, "batch_norm", dev)
        x32, lens_t, pos32 = layer_inputs(layer, lens, T, 9, dev)
        x, _, pos_p = bf16_layer_args(layer, lens, T, 9, dev)
        with torch.no_grad():
            err = bf16_close(
                run_sq_layer_bf16(sq.fused_squeezeformer_layer, layer, x,
                                  lens_t, pos_p),
                run_sq_layer_bf16(sq.fused_squeezeformer_layer_plain, layer,
                                  x, lens_t, pos_p),
                f"row 6 bf16, timed shape T'={T}")
            runs = alternate(
                lambda: run_sq_layer_bf16(sq.fused_squeezeformer_layer,
                                          layer, x, lens_t, pos_p),
                lambda: run_sq_layer(sq.fused_squeezeformer_layer, layer,
                                     x32, lens_t, pos32))
            plain = [cuda_ms(lambda: run_sq_layer_bf16(
                sq.fused_squeezeformer_layer_plain, layer, x, lens_t,
                pos_p), 5)]
        times[f"row6_T{T}"] = {
            "B": 8, "T": T, "bf16_ms": runs["kernel"], "f32_ms": runs["plain"],
            "bf16_plain_ms": plain,
            "matmul_bf16_ms": products_ms(8 * T, 256, 2048, dev),
            "max_abs_err": err, **layer_bound_bf16(layer, lens, T)}
    for B, rep in ((ENGINE_STREAMS, 1), (ENGINE_STREAMS, 2)):
        c, C = CHUNK // rep, CACHE // rep
        layer = seeded_sq_layer(60 + B + rep, True, "batch_norm", dev)
        clens, active = [C] * B, [1] * B
        wp, offs = [(2 * s + 1) % C for s in range(B)], [CACHE + 64 * s
                                                        for s in range(B)]
        args = sq_chunk_args_bf16(layer, B, c, C, rep, clens, wp, offs,
                                  active, 7 + B, dev)
        args32 = sq_chunk_inputs(layer, B, c, C, rep, clens, wp, offs,
                                 active, 7 + B, dev)
        with torch.no_grad():
            runs = alternate(
                lambda: run_sq_chunk(cks.fused_chunk_layer_sq, layer, args,
                                     rep=rep),
                lambda: run_sq_chunk(cks.fused_chunk_layer_sq, layer, args32,
                                     rep=rep))
            plain = [cuda_ms(lambda: run_sq_chunk(
                cks.fused_chunk_layer_sq_plain, layer, args, rep=rep), 5)]
        K = layer.cnn_module_kernel
        times[f"row8_{'full' if rep == 1 else 'half'}"] = {
            "B": B, "c": c, "C": C, "rep": rep, "bf16_ms": runs["kernel"],
            "f32_ms": runs["plain"], "bf16_plain_ms": plain,
            "matmul_bf16_ms": products_ms(B * c, 256, 2048, dev,
                                          rows_pw1=B * (K - 1 + c)),
            **chunk_bound_bf16(layer, clens, active, c, C, rep=rep)}
    for row, key, worst in (("row6", "row6_T299", worst6),
                            ("row8", "row8_full", worst8)):
        t = times[key]
        out[row] = {"ms": float(np.mean(t["bf16_ms"])),
                    "plain_ms": t["bf16_plain_ms"][0],
                    "library_ms": float(np.mean(t["matmul_bf16_ms"])),
                    "max_abs_err": worst, "bound_ms": t["bound_ms"],
                    "bound_by": t["bound_by"]}
    emit({"phase": "bf16_sq_kernels", "card": smi,
          "rule": "max abs err <= 8 bf16 roundings (2^-8) of the largest "
                  "output, mean <= one of the mean magnitude",
          "cases": cases, "times": times})
    return out


def family_launches(family):
    """(layer kernel launches, its bf16 launches, chunk kernel launches,
    its bf16 launches, serving products) of a family's serving rows."""
    lk, ck = layer_kernel(family), chunk_kernel(family)
    return (lk.launches, lk.bf16_launches, ck.launches, ck.bf16_launches,
            product_launches())


def bf16_engine(one, wavs, refs, n_layers):
    """A 32-stream BatchStreamSession over the bf16 predictor `one`
    (staggered as phase 46's), against the single streams `refs` by the
    margin rule: → (texts equal, dispatches, chunk-kernel launches of the
    run, its bf16 ones, serving products, wall)."""
    from masr_tpu_torch.infer.batch_stream import BatchStreamSession
    family = one.predictor.use_model
    sess = BatchStreamSession(
        one.predictor, one._vocab_list, max_streams=ENGINE_STREAMS,
        preprocess_conf=one.predictor.meta["preprocess_conf"])
    check(all(t.dtype == BF16 for t in sess.states.values() if t.dim() > 1),
          f"bf16 slot state ({family})")
    orig, dispatches = sess._dispatch, []
    top2 = {s: [] for s in range(ENGINE_STREAMS)}

    def spy(xs, active, valids, exact):
        rec = []
        with record_top2(rec):
            res = orig(xs, active, valids, exact)
        for slot, k in valids.items():
            top2[slot].append(rec[0][slot, :k])
        dispatches.append(int(np.sum(active)))
        return res

    sess._dispatch = spy
    streams = [wavs[k % len(wavs)] for k in range(ENGINE_STREAMS)]
    slots = [sess.open() for _ in streams]
    late = [3 * (k % 8) + k // 8 for k in range(len(streams))]
    texts = [None] * len(streams)
    # the main path: counts read around the engine run alone
    reset_launches()
    reset_family_bf16_launches()
    t0 = time.perf_counter()
    for i in range(max(len(w) // PIECE + 1 + d
                       for w, d in zip(streams, late))):
        items = [(s, w[(i - d) * PIECE:(i - d + 1) * PIECE],
                  (i - d + 1) * PIECE >= len(w))
                 for s, w, d in zip(slots, streams, late)
                 if 0 <= i - d and (i - d) * PIECE < len(w)]
        if items:
            for s, r in sess.feed_many(items).items():
                if r is not None:
                    texts[slots.index(s)] = r["text"]
    wall = time.perf_counter() - t0
    ck = chunk_kernel("squeezeformer" if family == "squeezeformer"
                      else "conformer")
    launches = (ck.launches, ck.bf16_launches, product_launches())
    check(launches[:2] == (n_layers * len(dispatches),) * 2,
          f"{family} bf16 engine chunk launches {launches[:2]} == {n_layers}"
          f" x {len(dispatches)} dispatches, all bf16")
    got = [{"text": t, "ids": np.asarray(sess._decoders[s]._max_index),
            "top2": np.concatenate(top2[s])} for s, t in zip(slots, texts)]
    margins = [same_text(g, refs[k % len(wavs)],
                         f"{family} bf16 engine stream {k}")
               for k, g in enumerate(got)]
    for s in slots:
        sess.close(s)
    check(all(not t.float().abs().sum() for t in sess.states.values()
              if t.dim() > 1), f"closed bf16 slots zero ({family})")
    return (sum(m is None for m in margins), len(dispatches), *launches,
            [m for m in margins if m is not None], wall)


def phase_bf16_family(dev, family, path, stream_path, wavs, smi,
                      per_encode, per_window):
    """49-51. A family at bf16: InferencePredictor(path, dtype=bf16)'s
    predict of the 8 utterances (per_encode: the expected
    family_launches(), no other row), the card's bf16 probs of the two
    shortest vs the CPU's bf16 twin route (bf16_probs_vs_cpu), walls beside
    f32; the bf16 predictor under predict_stream (per_window launches a
    window) and the 32-stream engine (texts == the single streams'). →
    (the encode's launches, the engine's)."""
    from masr_tpu_torch.infer.inference_model import InferencePredictor
    from masr_tpu_torch.infer.predictor import MASRPredictor
    t_phase = time.perf_counter()
    f32 = MASRPredictor(model_dir=path, device=dev, warmup=False)
    speech, lens = f32.featurize_batch(wavs)
    ip = InferencePredictor(path, device=dev, dtype=BF16)
    check(ip.model.encoder.compute_dtype == BF16, f"bf16 model ({family})")
    ip.predict(speech[:1], lens[:1])                      # warm
    reset_all_launches()
    reset_family_bf16_launches()
    ip.predict(speech, lens)
    torch.cuda.synchronize()
    encode = family_launches(family)
    own = (layer_kernel(family), chunk_kernel(family))
    others = {k: fn.launches for k, fn in all_kernels().items()
              if fn.launches and fn not in own}
    check(encode == per_encode and not others, f"{family} bf16 predict "
          f"launches {encode} == {per_encode} (layer, its bf16, chunk, its "
          f"bf16, products), no other row ({others})")
    order = np.argsort(lens)[:2]
    T2 = int(lens[order].max())
    p2, _ = f32.predictor.predict(speech[order, :T2], lens[order])
    err, dist, d_card, compared = bf16_probs_vs_cpu(
        ip, path, speech[order, :T2], lens[order], p2, family)
    walls = {"bf16": [], "f32": []}
    for name in ("f32", "bf16", "bf16", "f32"):
        pred = ip if name == "bf16" else f32.predictor
        t0 = time.perf_counter()
        pred.predict(speech, lens)
        walls[name].append(time.perf_counter() - t0)
    one = bf16_predictor(stream_path, dev, fused_frontend=False)
    refs = []
    for w in wavs:
        reset_all_launches()
        reset_family_bf16_launches()
        got = stream(one, w)
        n = family_launches(family)
        want = tuple(k * got["windows"] for k in per_window)
        check(n == want, f"{family} bf16 predict_stream launches {n} == "
              f"{per_window} x {got['windows']} windows")
        refs.append(got)
    check(all(r["text"] for r in refs), f"{family} bf16 texts not empty")
    equal, n_disp, *eng, parted, wall = bf16_engine(one, wavs, refs,
                                                    per_window[2])
    emit({"phase": "bf16_" + PHASE_PREFIX[family].rstrip("_"), "card": smi,
          "encode_launches": encode, "window_launches": per_window,
          "probs_max_abs_err_card_vs_cpu": err,
          "probs_cpu_bf16_vs_f32_max_abs": dist,
          "probs_card_bf16_vs_f32_max_abs": d_card,
          "argmax_frames_compared": compared, "predict_s": walls,
          "single_stream_windows": sum(r["windows"] for r in refs),
          "engine": {"streams": ENGINE_STREAMS, "dispatches": n_disp,
                     "chunk_launches": eng[0], "bf16_launches": eng[1],
                     "products": eng[2],
                     "texts_equal_single_stream": equal,
                     "parted_margins": parted, "wall_s": wall},
          "seconds": time.perf_counter() - t_phase})
    return encode, eng


# --------------------------------------------------------------------------- #
# bf16 training (masr_tpu's enable_amp): rows 3 and 7 in their bf16 modes,
# the flagship Conformer and the layer_norm Squeezeformer through
# MASRTrainer
# --------------------------------------------------------------------------- #
# steps of each enable_amp run (phase name → steps)
BF16_TRAIN_STEPS = {"train_bf16": 8, "sq_train_bf16": 8,
                    "sq_bn_train_bf16": 8, "eff_train_bf16": 8,
                    "ds2_train_bf16": 8}


def train_layer_args_bf16(layer, args):
    """train_layer_inputs' arguments in the bf16 mode: x and the cotangent
    weights w bf16, posp the bf16 product of the positions (f32 sums
    rounded once, as masr_tpu's), the bf16 pack (the Squeezeformer's
    unfolded)."""
    import torch.nn.functional as F
    from masr_tpu_torch.models.embedding import sinusoid_position_encoding
    x, w, mask, seeds, lens, _, _ = args
    T = x.shape[1]
    step = 2 if T < TRAIN_T else 1
    with torch.no_grad():
        pos = sinusoid_position_encoding(
            torch.arange(0, step * T, step, device=x.device), layer.size)
        posp = F.linear(pos.to(BF16),
                        layer.self_attn.linear_pos.weight.to(BF16))
        packed = {k: v.clone() for k, v in layer.packed_params(BF16).items()}
    return x.to(BF16), w.to(BF16), mask, seeds, lens, posp, packed


def check_train_layer_bf16(fns, layer, args, rates):
    """The bf16 training-layer kernel fns[0] vs its bf16 twin fns[1]: the
    output, dx, dposp and every packed array's grad of sum(y * w), each
    within 8 roundings (max) and one (mean) of its own magnitude (the card
    tests' _assert_bf16_train_close). → case dict."""
    res = []
    for fn in fns:
        y, xx, pp, pk = run_train_layer(fn, layer, args, rates)
        (y.float() * args[1].float()).sum().backward()
        torch.cuda.synchronize()
        res.append((y.detach(), {"x": xx.grad, "posp": pp.grad,
                                 **{k: v.grad for k, v in pk.items()}}))
    (y_k, g_k), (y_p, g_p) = res
    T = tuple(y_k.shape)[1]
    errs = {}
    for name, a, b in [("y", y_k, y_p)] + [(k, g_k[k], g_p[k]) for k in g_p]:
        check(a.dtype == b.dtype, f"bf16 train layer {name} dtypes")
        a, b = a.float(), b.float()
        check(bool(torch.isfinite(a).all()), f"bf16 train {name} finite")
        err = (a - b).abs()
        top = max(b.abs().max().item(), 1e-30)
        mean = max(b.abs().mean().item(), 1e-30)
        errs[name] = [err.max().item() / (BF16_ROUNDING * top),
                      err.mean().item() / (BF16_ROUNDING * mean)]
        check(errs[name][0] <= 8 and errs[name][1] <= 1, f"bf16 train layer "
              f"{name}: {errs[name]} roundings (max, mean) <= (8, 1) "
              f"(T'={T}, rates {rates})")
    return {"T": T, "rates": rates, "dtype": str(y_k.dtype),
            "max_abs_err": (y_k.float() - y_p.float()).abs().max().item(),
            "roundings": errs}


def train_layer_bound_bf16(layer, args):
    """train_layer_bound's operations over the bf16 dense rate; bytes: x,
    posp, y, dy, dx, dposp bf16, the bf16 pack and its grads, the mask."""
    x, _, mask, _, lens, posp, packed = args
    f32 = train_layer_bound(layer, args)
    pack = sum(t.numel() * t.element_size() for t in packed.values())
    nbytes = 2 * pack + mask.numel() + 2 * (4 * x.numel() + 2 * posp.numel())
    return {"gflop": f32["gflop"], "mbytes": nbytes / 1e6,
            **_bound_bf16(f32["gflop"] * 1e9, nbytes)}


def bf16_train_times(layer, f32_args, args, kernel, plain):
    """The bf16 training layer's forward and backward, kernel vs twin (CUDA
    events, plain, kernel, kernel, plain; dropout 0.1), beside the f32
    kernel at the same shape, and the bf16 bound → times dict."""
    fwd, bwd = time_train_layer({"plain": plain, "kernel": kernel},
                                layer, args, (0.1, 0.1))
    f_fwd, f_bwd = [], []        # the f32 kernel, same shape
    for _ in range(2):
        y = run_train_layer(kernel, layer, f32_args, (0.1, 0.1))[0]
        f_fwd.append(cuda_ms(lambda: run_train_layer(
            kernel, layer, f32_args, (0.1, 0.1))))
        f_bwd.append(cuda_ms(
            lambda: y.backward(f32_args[1], retain_graph=True)))
        del y
    return {"fwd_kernel_ms": fwd["kernel"], "bwd_kernel_ms": bwd["kernel"],
            "fwd_plain_ms": fwd["plain"], "bwd_plain_ms": bwd["plain"],
            "f32_fwd_kernel_ms": f_fwd, "f32_bwd_kernel_ms": f_bwd,
            "ms": float(np.mean(fwd["kernel"]) + np.mean(bwd["kernel"])),
            "plain_ms": float(np.mean(fwd["plain"]) + np.mean(bwd["plain"])),
            "f32_ms": float(np.mean(f_fwd) + np.mean(f_bwd)),
            **train_layer_bound_bf16(layer, args)}


def bf16_train_profile(layer, args, kernel, module, entry):
    """One bf16 forward + backward of a training layer (dropout 0.1, grads
    of x, posp and the pack by torch.autograd.grad) under torch.profiler:
    each CUDA kernel's device ms per call (5 calls), the products
    (tw_gemm_kernel and its split-K sums) apart from the rest, the kernels
    and copies one call launches; the mode's saved and scratch bytes at
    this shape (module's C entries); the layer's product shapes as
    torch.matmul bf16, device ms over one forward + backward (a yardstick
    only). → dict."""
    from masr_tpu_torch.bench.kernel_digest import train_products
    x, w, mask, seeds, lens, posp, packed = args
    leaves = [t.clone().requires_grad_(True)
              for t in [x, posp] + list(packed.values())]
    pk = dict(zip(packed, leaves[2:]))

    def call():
        y = kernel(leaves[0], mask, seeds, lens, leaves[1], pk, layer=5,
                   n_head=layer.attention_heads,
                   ksize=layer.cnn_module_kernel, causal=layer.causal,
                   rate=0.1, att_rate=0.1)
        torch.autograd.grad(y, leaves, w)

    kern = device_kernels(call, n=5)
    prod = sum(v for k, v in kern.items()
               if "gemm" in k or "tw_sum" in k or "splitk_sum" in k)
    _, launches = profiled_launches(call)
    B, T, D = x.shape
    F, H = packed["ffw1"].shape[2], layer.attention_heads
    lib = module._lib()
    g = torch.Generator().manual_seed(14)
    mats = [(torch.randn(n, M, K, generator=g).to(x.device, BF16),
             torch.randn(n, K, N, generator=g).to(x.device, BF16), times)
            for (n, M, N, K), times
            in train_products(B, T, D, F, H).values()]

    def matmuls():
        for a, b, times in mats:
            for _ in range(times):
                a @ b

    return {"kernels": kern, "products_ms": prod,
            "rest_ms": sum(kern.values()) - prod,
            "device_ms": sum(kern.values()), "launches": launches,
            "saved_bytes": 4 * getattr(lib, entry + "_saved_floats")(
                B, T, D, F, H, 1),
            "scratch_bytes": 4 * getattr(lib, entry + "_scratch_floats")(
                B, T, D, F, H, 1),
            "matmul_bf16_ms": sum(device_kernels(matmuls, n=3).values())}


def phase_train_kernels_bf16(dev, smi):
    """Rows 3 and 7 in their bf16 modes vs their bf16 twins at phases 11
    and 19's shapes (B=8, T'=299; the Squeezeformer also at half rate,
    T'=150), dropout 0 and 0.1 / 0.1: output and every grad; forward +
    backward timed (CUDA events, dropout 0.1) beside the f32 kernel and
    the bf16 twin in the same call, with the bf16 bound; one forward +
    backward profiled (bf16_train_profile: the kernels' device split, the
    launches, saved and scratch bytes, the torch.matmul bf16 yardstick).
    → {row: entry}."""
    from masr_tpu_torch.ops.cuda import conformer_layer_train as clt
    from masr_tpu_torch.ops.cuda import squeezeformer_layer_train as sqt
    t0 = time.perf_counter()
    out, cases = {}, {}
    for row, layer, kernel, plain, module, entry in (
            ("row3", seeded_layer(21, True, dev),
             clt.fused_conformer_layer_train,
             clt.fused_conformer_layer_train_plain, clt,
             "masr_conformer_layer_train"),
            ("row7", seeded_sq_layer(31, True, "layer_norm", dev),
             sqt.fused_squeezeformer_layer_train,
             sqt.fused_squeezeformer_layer_train_plain, sqt,
             "masr_sq_layer_train")):
        halves = (False, True) if row == "row7" else (False,)
        cases[row], times = [], {}
        for half in halves:
            f32_args = train_layer_inputs(layer, 22, dev, half)
            args = train_layer_args_bf16(layer, f32_args)
            cases[row] += [check_train_layer_bf16((kernel, plain), layer,
                                                  args, rates)
                           for rates in ((0.0, 0.0), (0.1, 0.1))]
            times["T150" if half else "T299"] = bf16_train_times(
                layer, f32_args, args, kernel, plain)
            times["T150" if half else "T299"]["profile"] = \
                bf16_train_profile(layer, args, kernel, module, entry)
        main = times["T299"]
        out[row] = {"max_abs_err": max(c["max_abs_err"] for c in cases[row]),
                    "ms": main["ms"], "plain_ms": main["plain_ms"],
                    "bound_ms": main["bound_ms"],
                    "bound_by": main["bound_by"], "library_ms": None,
                    "times": times}
    emit({"phase": "train_kernels_bf16", "card": smi, "B": len(TRAIN_LENS),
          "lens": TRAIN_LENS, "rule": "8 roundings max, 1 mean, of each "
          "output's and grad's own magnitude", "cases": cases,
          "times": {r: o["times"] for r, o in out.items()},
          "seconds": time.perf_counter() - t0})
    return out


def corpus_every(corpus, root, step):
    """Every `step`-th training utterance of a corpus (its test set,
    vocabulary and CMVN kept)."""
    os.makedirs(root, exist_ok=True)
    out = dict(corpus)
    with open(corpus["train"], encoding="utf-8") as f:
        lines = [l for l in f if l.strip()][::step]
    out["train"] = os.path.join(root, "manifest.train")
    with open(out["train"], "w", encoding="utf-8") as f:
        f.writelines(lines)
    return out


def amp_config(config, steps):
    """config(corpus, save_dir, max_epoch, dropout) with enable_amp, one
    optimizer update a step and a short schedule (WarmupLR: 4 warmup
    steps; NoamHoldAnnealing: max_steps cut to the run's `steps`), so the
    loss falls within the bf16 run's few steps."""
    def conf(corpus, save_dir, max_epoch, dropout=True):
        c = config(corpus, save_dir, max_epoch, dropout)
        c["train_conf"] = dict(c["train_conf"], enable_amp=True,
                               accum_grad=1)
        o = c["optimizer_conf"]
        if o["scheduler"] == "WarmupLR":
            sched = dict(warmup_steps=4, min_lr=1e-5)
        else:
            sched = dict(o["scheduler_conf"], max_steps=steps)
        c["optimizer_conf"] = dict(o, scheduler_conf=sched)
        return c
    return conf


def mean_rel(a, b):
    """mean |a - b| over mean |b|."""
    a, b = a.double(), b.double()
    return ((a - b).abs().mean() / b.abs().mean().clamp(min=1e-30)).item()


def first_step_bf16(conf, sample, prepare=None, draws=1):
    """The first train step at dropout 0 from one init and batch, the CTC
    loss alone backward (the attention loss's encoder grads pass the
    decoder FFN's ReLU derivative, which flips on the card): the card's
    bf16 step against the CPU's f32 one may stray no further than twice as
    far as the CPU's bf16 route does (loss; mean error of each sampled
    grad), with a floor of one bf16 rounding of the loss. With draws = 3
    each bf16 route takes three first steps, on the batch's features scaled
    by 1, 1 + 2^-23 and 1 - 2^-23 (at most one f32 rounding apart): the
    loss by each side's median over them, the grads by each side's mean
    error pooled over every sampled grad and every draw (each grad's
    median reported). On the eager BatchNorm route one such rounding moved
    either side's grad error by up to 2.6x, every sampled grad together
    (chip probes on an H100: the error is no few outliers, the median
    element moves with the mean), and the card's ratio to the CPU's, one
    grad of one draw, ran 0.6-3.7 over the probes, so one grad of one step
    is one draw of a statistic that swings. → summary."""
    from masr_tpu_torch.training.train_state import batch_to, step_generators
    from masr_tpu_torch.training.trainer import MASRTrainer
    models, batch = {}, None
    for name, device, amp in (("card_bf16", "cuda", True),
                              ("cpu_bf16", "cpu", True),
                              ("cpu_f32", "cpu", False)):
        c = dict(conf, train_conf=dict(conf["train_conf"], enable_amp=amp))
        t = MASRTrainer(c, device=device)
        ds, _, loader = t._setup_dataloader(True)
        t._setup_model(ds.feature_dim, ds.vocab_size)
        if prepare is not None:
            prepare(t.model)
        if batch is None:
            batch = next(iter(loader))
        models[name] = t

    def step(name, scale):
        t = models[name]
        t.model.zero_grad(set_to_none=True)
        b = batch_to(batch, t.device)
        gen, chunk = step_generators(0, 0, t.device)
        out = t.model.train()(b["inputs"] * scale, b["input_lens"],
                              b["labels"], b["label_lens"], generator=gen,
                              chunk_generator=chunk)
        out["loss_ctc"].backward()
        params = dict(t.model.named_parameters())
        return (float(out["loss_ctc"].detach()),
                {n: params[n].grad.detach().float().cpu() for n in sample})

    scales = [1.0, 1.0 + 2.0 ** -23, 1.0 - 2.0 ** -23][:draws]
    l_32, g_32 = step("cpu_f32", 1.0)
    got = {name: [step(name, sc) for sc in scales]
           for name in ("card_bf16", "cpu_bf16")}

    def median(name, fn):
        return float(np.median([fn(*r) for r in got[name]]))

    loss_card = median("card_bf16", lambda l, g: abs(l - l_32))
    loss_cpu = median("cpu_bf16", lambda l, g: abs(l - l_32))
    l_card, l_cpu = got["card_bf16"][0][0], got["cpu_bf16"][0][0]
    check(loss_card <= max(2 * loss_cpu, BF16_ROUNDING * abs(l_32)),
          f"bf16 first-step CTC loss: card {l_card} vs f32 {l_32} "
          f"({loss_card}) within twice the CPU bf16's ({l_cpu}, "
          f"{loss_cpu}; medians over {draws} draws)")
    grads = {n: {"card_vs_f32": median(
        "card_bf16", lambda l, g, n=n: mean_rel(g[n], g_32[n])),
        "cpu_bf16_vs_f32": median(
            "cpu_bf16", lambda l, g, n=n: mean_rel(g[n], g_32[n]))}
        for n in sample}
    pooled = None
    if draws == 1:
        for n, d in grads.items():
            check(d["card_vs_f32"] <= 2 * d["cpu_bf16_vs_f32"], f"bf16 "
                  f"first step {n}: card {d['card_vs_f32']} <= 2 x CPU "
                  f"bf16 {d['cpu_bf16_vs_f32']} (mean error vs the CPU's "
                  f"f32); every sampled grad: {grads}")
    else:
        pooled = {name: float(np.mean([mean_rel(g[n], g_32[n])
                                       for _, g in got[name]
                                       for n in sample]))
                  for name in ("card_bf16", "cpu_bf16")}
        check(pooled["card_bf16"] <= 2 * pooled["cpu_bf16"], f"bf16 first "
              f"step: card {pooled['card_bf16']} <= 2 x CPU bf16 "
              f"{pooled['cpu_bf16']} (mean error vs the CPU's f32 over "
              f"{len(sample)} sampled grads and {draws} draws); each grad's "
              f"medians: {grads}")
    return {"ctc_loss": {"card_bf16": l_card, "cpu_bf16": l_cpu,
                         "cpu_f32": l_32}, "draws": draws,
            "grads_mean_rel_pooled": pooled, "grads_mean_rel": grads}


def phase_eff_train_kernels_bf16(dev, smi):
    """Row 3's bf16 mode at the Efficient-Conformer tail's shape (B=8,
    T'=150 of 299, K=7, the chunk mask's [::2, ::2] view, the lengths
    halved rounding up), causal and not, dropout 0 and 0.1 / 0.1, against
    its bf16 twin: the output and every grad within 8 roundings (max) and
    one (mean) of its own magnitude; forward + backward timed beside the f32
    kernel at the same shape. → summary dict."""
    from masr_tpu_torch.ops.cuda import conformer_layer_train as clt
    t0 = time.perf_counter()
    kernel, plain = (clt.fused_conformer_layer_train,
                     clt.fused_conformer_layer_train_plain)
    cases, times = [], {}
    for causal in (True, False):
        layer = seeded_eff_layer(41 + causal, causal, dev)
        f32_args = train_layer_inputs(layer, 44 + causal, dev, half=True)
        args = train_layer_args_bf16(layer, f32_args)
        check(tuple(args[2].shape) == (8, EFF_T, EFF_T)
              and not args[2].is_contiguous()
              and args[4].tolist() == EFF_LENS,
              "row 3 bf16 takes the strided mask view and the halved lengths")
        cases += [dict(check_train_layer_bf16((kernel, plain), layer, args,
                                              rates), causal=causal)
                  for rates in ((0.0, 0.0), (0.1, 0.1))]
        times["causal" if causal else "non_causal"] = bf16_train_times(
            layer, f32_args, args, kernel, plain)
    main = times["causal"]
    out = {"max_abs_err": max(c["max_abs_err"] for c in cases),
           "ms": main["ms"], "plain_ms": main["plain_ms"],
           "f32_ms": main["f32_ms"], "bound_ms": main["bound_ms"],
           "bound_by": main["bound_by"]}
    emit({"phase": "eff_train_kernels_bf16", "card": smi,
          "B": len(EFF_LENS), "T": EFF_T, "lens": EFF_LENS,
          "conv_kernel": EFF_TAIL_KERNEL, "rule": "8 roundings max, 1 mean, "
          "of each output's and grad's own magnitude", "cases": cases,
          "times": times, **out, "seconds": time.perf_counter() - t0})
    return out


def sq_bn_train_config(corpus, save_dir, max_epoch, dropout=True):
    """configs/squeezeformer.yml's default: the BatchNorm conv module."""
    return sq_train_config(corpus, save_dir, max_epoch, dropout,
                           conv_norm="batch_norm")


def ds2_amp_config(corpus, save_dir, max_epoch, dropout=True):
    """ds2_train_config (DS2 has no dropout to turn off)."""
    return ds2_train_config(corpus, save_dir, max_epoch)


EFF_BF16_SAMPLE = ["encoder.embed.out.0.weight",
                   "encoder.encoders.0.self_attn.pos_bias_u",
                   "encoder.encoders.3.conv_module.depthwise_conv.weight",
                   "encoder.encoders.3.conv_module.norm.weight",
                   "encoder.encoders.7.self_attn.linear_q.weight",
                   "encoder.encoders.11.norm_final.weight",
                   "ctc.ctc_lo.weight"]
DS2_BF16_SAMPLE = ["encoder.rnns.0.rnn.weight_ih_l0",
                   "encoder.rnns.0.rnn.weight_hh_l0",
                   "encoder.rnns.2.rnn.bias_hh_l0",
                   "encoder.rnns.4.rnn.weight_hh_l0",
                   "encoder.rnns.4.layer_norm.weight",
                   "ctc.ctc_lo.weight"]
PIPELINE_TRAIN, PIPELINE_TEST = 16, 2

# run in a subprocess in which jax, jaxlib, flax and masr_tpu cannot be
# imported: the port's CLIs through runpy, as `python -m` runs them
PIPELINE_CODE = """
import json, runpy, sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "masr_tpu"):
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
sys.path.insert(0, REPO)
import torch
from masr_tpu_torch.ops.cuda import chunk_layer, conformer_layer
from masr_tpu_torch.ops.cuda import conformer_layer_train, ctc_loss
COUNTERS = {"conformer_layer": conformer_layer.fused_conformer_layer,
            "chunk_layer": chunk_layer.fused_chunk_layer,
            "conformer_layer_train":
                conformer_layer_train.fused_conformer_layer_train,
            "ctc_loss": ctc_loss.ctc_loss}
P = PIPE
GPU = ("--use_gpu", str(P["use_gpu"]))
def sync():
    if P["use_gpu"]:
        torch.cuda.synchronize()
def cli(module, *args):
    for fn in COUNTERS.values():
        fn.launches = 0
    sys.argv = [module] + list(args) + list(GPU)
    runpy.run_module(module, run_name="__main__", alter_sys=True)
    sync()
    return {k: fn.launches for k, fn in COUNTERS.items()}
out = {"launches": {}}
out["launches"]["create_data_merge"] = cli(
    "masr_tpu_torch.create_data", "--configs", P["merge_conf"],
    "--annotation_path", P["merge_annotation"], "--noise_dir", "",
    "--count_threshold", "1", "--is_merge_audio", "True",
    "--max_duration", "20", "--save_audio_path", P["merge_audio"])
out["launches"]["create_data"] = cli(
    "masr_tpu_torch.create_data", "--configs", P["conf"],
    "--annotation_path", P["annotation"], "--noise_dir", "",
    "--count_threshold", "1")
out["launches"]["extract_features"] = cli(
    "masr_tpu_torch.extract_features", "--configs", P["conf"],
    "--save_dir", P["features"])
out["launches"]["train"] = cli(
    "masr_tpu_torch.train", "--configs", P["feat_conf"],
    "--save_model_path", P["models"], "--augment_conf_path", "none")
out["launches"]["export_model"] = cli(
    "masr_tpu_torch.export_model", "--configs", P["feat_conf"],
    "--save_model_path", P["models"], "--resume_model", P["last_model"])
from masr_tpu_torch import infer_path
for tag, bundle, wav, long_wav in (
        ("", P["bundle"], P["wav"], P["long_wav"]),
        ("example_", P["example"], P["example_wav"], None)):
    for mode, path, extra in (
            ("short", wav, []),
            ("long", long_wav, ["--is_long_audio", "True"]),
            ("demo", wav, ["--real_time_demo", "True"])):
        if path is None:
            continue
        for fn in COUNTERS.values():
            fn.launches = 0
        out[tag + mode] = infer_path.main(["--wav_path", path, "--model_dir",
                                           bundle] + extra + list(GPU))
        sync()
        out["launches"]["infer_path_" + tag + mode] = {
            k: fn.launches for k, fn in COUNTERS.items()}
out["jax_loaded"] = sorted(m for m in sys.modules if m.split(".")[0] in
                           ("jax", "jaxlib", "flax", "masr_tpu"))
print(json.dumps(out, ensure_ascii=False))
"""


def pipeline_annotations(corpus, root):
    """Annotation files (`<wav>\\t<text>`) of phase 12's first
    PIPELINE_TRAIN training utterances and PIPELINE_TEST test ones, their
    wavs copied under root/audio → the annotation directory."""
    ann, audio = os.path.join(root, "annotation"), os.path.join(root, "audio")
    os.makedirs(ann, exist_ok=True)
    os.makedirs(audio, exist_ok=True)
    for split, n in (("train", PIPELINE_TRAIN), ("test", PIPELINE_TEST)):
        lines = []
        with open(corpus[split], encoding="utf-8") as f:
            entries = [json.loads(l) for l in f if l.strip()][:n]
        for i, e in enumerate(entries):
            path = os.path.join(audio, f"{split}_{i}.wav")
            shutil.copyfile(e["audio_filepath"], path)
            lines.append(f"{path}\t{e['text']}")
        with open(os.path.join(ann, f"{split}.txt"), "w",
                  encoding="utf-8") as f:
            f.write("\n".join(lines) + "\n")
    return ann


def phase_pipeline(dev, corpus, smi):
    """The user's pipeline without JAX on the card: in a subprocess whose
    meta-path blocks jax, jaxlib, flax and masr_tpu, `python -m
    masr_tpu_torch.create_data` (also with --is_merge_audio True on a copy),
    `.extract_features`, the train CLI (the flagship of configs/conformer.yml
    at full width, one epoch of 2 steps at B=8 on the .feature manifests),
    `.export_model`, then `.infer_path` short, long (--is_long_audio) and
    the real-time demo (--real_time_demo), all on the card. Checks: each
    step's outputs exist and are well formed; the launches of rows 1-4 in
    each (set to 0 before each CLI, read after it: the train steps 12 + 12
    row-3 and 1 + 1 row-4 launches each, the encodes 12 row-1 launches, the
    demo's windows 12 row-2 launches each); infer_path's texts equal the
    in-process predictor's on the card; nothing of JAX was imported."""
    from masr_tpu_torch.audio import AudioSegment
    from masr_tpu_torch.audio.io import write_wave
    from masr_tpu_torch.audio.synth_tts import SyntheticTTS
    from masr_tpu_torch.data.manifest import read_manifest
    from masr_tpu_torch.infer.predictor import MASRPredictor
    t0 = time.perf_counter()
    root = os.path.join(WORK, "pipeline")
    shutil.rmtree(root, ignore_errors=True)
    ann = pipeline_annotations(corpus, root)
    merge_root = os.path.join(root, "merge_copy")
    shutil.copytree(root, merge_root)
    merge_ann = os.path.join(merge_root, "annotation")
    for name in os.listdir(merge_ann):     # the copy names its own wavs
        path = os.path.join(merge_ann, name)
        with open(path, encoding="utf-8") as f:
            text = f.read().replace(os.path.join(root, "audio"),
                                    os.path.join(merge_root, "audio"))
        with open(path, "w", encoding="utf-8") as f:
            f.write(text)

    def data_corpus(base, suffix=""):
        d = os.path.join(base, "dataset")
        return {"train": os.path.join(d, "manifest.train" + suffix),
                "test": os.path.join(d, "manifest.test" + suffix),
                "vocab": os.path.join(d, "vocabulary.txt"),
                "cmvn": os.path.join(d, "mean_istd.json")}

    def conf_of(c, save_dir):
        conf = train_config(c, save_dir, 1)
        conf["train_conf"] = dict(conf["train_conf"], accum_grad=1,
                                  log_interval=1)
        conf["dataset_conf"] = dict(conf["dataset_conf"], min_duration=0)
        return conf

    models = os.path.join(root, "models")
    run_dir = os.path.join(models, "conformer_streaming_fbank")
    wav = os.path.join(root, "audio", "test_0.wav")
    long_wav = os.path.join(root, "long.wav")
    rec = long_recording(n_items=6, seed=9)
    write_wave(long_wav, rec + 1e-3 * np.random.RandomState(9)
               .standard_normal(len(rec)).astype(np.float32), 16000)
    # the example bundle recognises its corpus's voice: a held-out
    # sentence between two silences, so that its texts are not empty
    example_wav = os.path.join(root, "example.wav")
    voice = SyntheticTTS(sample_rate=16000).render(*HELD_OUT[0])
    pad = np.zeros(8000, np.float32)
    speech = np.concatenate([pad, voice, pad])
    write_wave(example_wav, speech + 1e-3 * np.random.RandomState(10)
               .standard_normal(len(speech)).astype(np.float32), 16000)
    pipe = {"conf": config_file(conf_of(data_corpus(root), root),
                                os.path.join(root, "conf.yml")),
            "merge_conf": config_file(conf_of(data_corpus(merge_root),
                                              merge_root),
                                      os.path.join(root, "merge.yml")),
            "feat_conf": config_file(conf_of(data_corpus(root, ".feature"),
                                             root),
                                     os.path.join(root, "feat.yml")),
            "annotation": ann, "merge_annotation": merge_ann,
            "merge_audio": os.path.join(merge_root, "merged"),
            "features": os.path.join(root, "features"), "models": models,
            "last_model": os.path.join(run_dir, "last_model"),
            "bundle": os.path.join(run_dir, "inference_model"),
            "wav": wav, "long_wav": long_wav,
            "example": TINY_BUNDLE, "example_wav": example_wav,
            "use_gpu": dev.type == "cuda"}
    code = f"REPO = {REPO!r}\nPIPE = {pipe!r}\n" + PIPELINE_CODE
    run = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=root)
    check(run.returncode == 0, f"pipeline subprocess exit "
          f"{run.returncode}: {run.stderr[-3000:]}")
    out = json.loads(run.stdout.strip().splitlines()[-1])
    check(out["jax_loaded"] == [],
          f"the pipeline imported {out['jax_loaded']}")
    d = data_corpus(root)
    train, test = read_manifest(d["train"]), read_manifest(d["test"])
    check(len(train) == PIPELINE_TRAIN and len(test) == PIPELINE_TEST and
          [e["duration"] for e in train] == sorted(e["duration"]
                                                   for e in train),
          f"create_data: {len(train)} / {len(test)} utterances, sorted")
    with open(d["vocab"], encoding="utf-8") as f:
        vocab = [l.split("\t")[0] for l in f.read().splitlines()]
    check(vocab[:2] == ["<blank>", "<unk>"] and vocab[-1] == "<eos>" and
          set("".join(e["text"] for e in train + test)) <= set(vocab),
          f"create_data vocabulary of {len(vocab)} tokens")
    with open(d["cmvn"], encoding="utf-8") as f:
        stats = json.load(f)
    check(len(stats["mean"]) == len(stats["istd"]) == PREPROCESS["n_mels"]
          and stats["frame_num"] > 0 and np.isfinite(stats["istd"]).all(),
          "create_data mean_istd.json")
    merged = read_manifest(os.path.join(merge_ann, "train.merge.json"))
    check(len(merged) == PIPELINE_TRAIN and not os.path.exists(
        os.path.join(merge_ann, "train.txt")) and len(read_manifest(
            data_corpus(merge_root)["train"])) + len(read_manifest(
                data_corpus(merge_root)["test"])) == PIPELINE_TRAIN
        + PIPELINE_TEST, f"create_data --is_merge_audio: {len(merged)} "
        f"merged entries")
    fd = data_corpus(root, ".feature")
    slabs = sorted(n for n in os.listdir(pipe["features"])
                   if n.endswith(".npy"))
    feats = read_manifest(fd["train"]) + read_manifest(fd["test"])
    check(len(feats) == PIPELINE_TRAIN + PIPELINE_TEST and slabs and all(
        e["end_frame"] > e["start_frame"] for e in feats),
        f"extract_features: {len(feats)} entries in {len(slabs)} slabs")
    L = out["launches"]
    steps = PIPELINE_TRAIN // len(TRAIN_LENS)
    n = FLAGSHIP_ENCODER["num_blocks"]
    check(L["train"]["conformer_layer_train"] >= 2 * n * steps and
          L["train"]["ctc_loss"] >= 2 * steps, f"train CLI launches "
          f"{L['train']}: at least {steps} steps of 24 row-3 and 2 row-4")
    check(os.path.exists(os.path.join(pipe["bundle"], "model.msgpack")),
          "export_model wrote the bundle")
    # MASRPredictor's warmup runs one encode (n row-1 launches) and one
    # streaming window (n row-2 launches) before each mode's own work
    short, long_, demo = (L["infer_path_" + m] for m in ("short", "long",
                                                         "demo"))
    check(short["conformer_layer"] == 2 * n and short["chunk_layer"] == n
          and long_["conformer_layer"] >= 2 * n and
          long_["conformer_layer"] % n == 0 and long_["chunk_layer"] == n
          and demo["conformer_layer"] == n and demo["chunk_layer"] > n and
          demo["chunk_layer"] % n == 0, f"infer_path launches: short "
          f"{short}, long {long_}, demo {demo} (warmup: {n} + {n})")
    got, want = {}, {}
    for tag, bundle, path, long_path in (
            ("", pipe["bundle"], wav, long_wav),
            ("example_", TINY_BUNDLE, example_wav, None)):
        pred = MASRPredictor(model_dir=bundle, device=dev)
        want[tag + "short"] = pred.predict(path)["text"]
        if long_path is not None:
            want[tag + "long"] = pred.predict_long(long_path)["text"]
            got[tag + "long"] = out[tag + "long"]["text"]
        seg = AudioSegment.from_file(path)
        step = int(0.5 * seg.sample_rate)
        last = None
        for i in range(0, len(seg.samples), step):
            r = pred.predict_stream(seg.samples[i:i + step],
                                    is_end=i + step >= len(seg.samples),
                                    sample_rate=seg.sample_rate)
            last = r or last
        want[tag + "demo"] = last["text"]
        got[tag + "short"] = out[tag + "short"]["text"]
        got[tag + "demo"] = out[tag + "demo"][-1]["text"]
    check(got == want, f"infer_path texts {got} == the predictor's {want}")
    check(bool(got["example_short"]), f"the example bundle's infer_path "
          f"text is not empty (said {HELD_OUT[0][0]!r})")
    emit({"phase": "pipeline", "card": smi, "train_utterances": len(train),
          "test_utterances": len(test), "vocab": len(vocab),
          "slabs": len(slabs), "train_steps": steps, "launches": L,
          "texts": got, "seconds": time.perf_counter() - t0})
    return L


def bf16_run_launches():
    """Every row's launches and bf16 launches, and serving_product's."""
    from masr_tpu_torch.ops.cuda.chunk_layer import serving_product
    out = {}
    for name, fn in all_kernels().items():
        out[name] = fn.launches
        if hasattr(fn, "bf16_launches"):
            out[name + "_bf16"] = fn.bf16_launches
    out["serving_product"] = serving_product.launches
    return out


def reset_bf16_run_launches():
    from masr_tpu_torch.ops.cuda.chunk_layer import serving_product
    reset_all_launches()
    for fn in all_kernels().values():
        if hasattr(fn, "bf16_launches"):
            fn.bf16_launches = 0
    serving_product.launches = 0


def phase_train_bf16(dev, name, family, corpus, f32_rows, smi, config,
                     sample, prepare=None, n=12, draws=1):
    """MASRTrainer with train_conf.enable_amp at the family's flagship
    widths: BF16_TRAIN_STEPS[name] steps at B=8, half of them in a first
    trainer and half in a second that resumes from last_model; every step
    n + n bf16 launches of the family's training-layer kernel (n = 0 where
    the layers train eagerly: the BatchNorm conv module, DeepSpeech2) and
    no f32 one, and 1 + 1 of the CTC kernel (f32, as masr_tpu's); the loss
    per label token falls; the first step against the CPU
    (first_step_bf16, over `draws` first steps); the f32 export loaded by
    InferencePredictor(dtype=bf16) gives the trained bf16 model's probs
    exactly; step walls beside the family's f32 run's. Every count is set
    to 0 before the two train() calls and read after them (the launches of
    the validation passes included: `run_launches`). → bf16 launches of
    the training-layer kernel in the run."""
    from masr_tpu_torch.infer.inference_model import InferencePredictor
    from masr_tpu_torch.training.trainer import MASRTrainer
    t_phase = time.perf_counter()
    root = os.path.join(WORK, name)
    shutil.rmtree(root, ignore_errors=True)
    steps = BF16_TRAIN_STEPS[name]
    part = corpus_every(corpus, os.path.join(root, "corpus"),
                        2 * TRAIN_STEPS_PER_EPOCH // steps)
    conf = amp_config(config, steps)
    save = os.path.join(root, "models")
    kernel = train_layer_kernel(family)
    rows = []
    reset_bf16_run_launches()
    with clocked_train_steps(rows, family):
        MASRTrainer(conf(part, root, 1), device="cuda").train(
            save_model_path=save, augment_conf_path=None)
        resumed = MASRTrainer(conf(part, root, 2), device="cuda")
        resumed.train(save_model_path=save, augment_conf_path=None)
    bf16_launched, run = kernel.bf16_launches, bf16_run_launches()
    check(len(rows) == steps and resumed.state.step == steps,
          f"{name}: {len(rows)} steps, resumed at {resumed.state.step}")
    check(resumed.model.encoder.compute_dtype == BF16 and all(
        p.dtype == torch.float32 for p in resumed.model.parameters()),
        f"{name}: bf16 compute, f32 parameters")
    for i, r in enumerate(rows):
        check(r["launches"] == [2 * n, n, 2, 1], f"{name} step {i} launches "
              f"{r['launches']}, want {[2 * n, n, 2, 1]}")
        check(r["finite"] and np.isfinite(r["loss"]), f"{name} step {i} "
              f"loss finite")
    # each epoch's validation pass (no grad) runs the forwards too
    check(bf16_launched == kernel.launches >= 2 * n * steps, f"{name}: "
          f"{bf16_launched} bf16 launches of the training layer, every one "
          f"of the run's {kernel.launches} and at least {2 * n * steps}")
    per_token = np.asarray([r["loss"] / r["tokens"] for r in rows])
    k = max(2, steps // 4)
    head, tail = float(per_token[:k].mean()), float(per_token[-k:].mean())
    check(tail < head, f"{name}: loss per label token falls, first {k} "
          f"steps {head}, last {k} {tail}")
    first = first_step_bf16(conf(part, root, 1, dropout=False), sample,
                            prepare, draws)
    # export: f32 parameters; the bundle at bf16 gives the model's probs
    run_dir = os.path.join(save, f"{family}_streaming_fbank")
    bundle = resumed.export(save_model_path=save,
                            resume_model=os.path.join(run_dir, "last_model"))
    pred = InferencePredictor(bundle, dtype=BF16, device=dev)
    feats = torch.randn(2, 1200, PREPROCESS["n_mels"],
                        generator=torch.Generator().manual_seed(5)).to(dev)
    lens = torch.tensor([1200, 777], device=dev)
    with torch.no_grad():
        want, _ = resumed.model.eval().get_encoder_out(feats, lens)
        got, _ = pred.model.get_encoder_out(feats, lens)
    check(want.dtype == torch.float32 and bool(torch.equal(got, want)),
          f"{name}: the exported bundle at bf16 gives the trained model's "
          f"probs (max diff {(got - want).abs().max().item()})")
    bf16_t, f32_t = step_times(rows), step_times(f32_rows)
    emit({"phase": name, "card": smi, "family": family, "steps": len(rows),
          "batch": len(TRAIN_LENS), "resumed_at_step": steps // 2,
          "launches": {"train_layer_bf16": bf16_launched,
                       "per_step": rows[0]["launches"]},
          "run_launches": run, "losses": [r["loss"] for r in rows],
          "loss_per_token_head": head, "loss_per_token_tail": tail,
          "first_step_card_vs_cpu": first, "export": bundle,
          **bf16_t, "f32_step_s_median": f32_t["step_s_median"],
          "f32_step_s_median_loader_reading":
              f32_t["step_s_median_loader_reading"],
          "f32_step_s_median_loader_done": f32_t["step_s_median_loader_done"],
          "seconds": time.perf_counter() - t_phase})
    return bf16_launched


# --------------------------------------------------------------------------- #
# phases 60-64: the user tools and the GUI controller
# --------------------------------------------------------------------------- #
TOOLS_UTTERANCES = 4      # phase 60's predict_batch, phase 62's grid
SOAK_MINUTES = 3          # minute 1 warms up; memory read after each
SOAK_POS_TABLE = 512      # horizon 512 - (256 + 16) = 240 frames, 9.6 s
SOAK_MEMORY_BOUND = 1 << 20   # bytes of device memory a soak minute may add


def phase_convert_checkpoint(dev, corpus, wavs):
    """`python -m masr_tpu_torch.tools.convert_masr_checkpoint`'s main on an
    upstream MASR model.pt of the flagship (phase 12's config: 12 blocks,
    3 + 3 decoder blocks, the corpus's 4000 words and CMVN), weights from
    seed 7 (seeded_state_dict, CTC head x8) plus the entries an upstream
    file carries beside (`.concat_linear.`, num_batches_tracked, the
    global CMVN). The bundle's predict_batch probs of 4 utterances on the
    card == the same state dict's model on the card (bits: both run the
    same kernels on the same weights); 12 row-1 launches per encode; probs
    and texts against the CPU's by probs_card_vs_cpu's rule. → the
    bundle."""
    from masr_tpu_torch.data.normalizer import FeatureNormalizer
    from masr_tpu_torch.infer.predictor import MASRPredictor
    from masr_tpu_torch.models.cmvn import GlobalCMVN
    from masr_tpu_torch.models.registry import build_model
    from masr_tpu_torch.models.weights import (load_upstream_state_dict,
                                               seeded_state_dict)
    from masr_tpu_torch.tools import convert_masr_checkpoint
    t0 = time.perf_counter()
    root = os.path.join(WORK, "convert")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    conf = train_config(corpus, root, 1)
    norm = FeatureNormalizer(corpus["cmvn"])
    model = build_model("conformer", 80, VOCAB,
                        encoder_conf=conf["encoder_conf"],
                        decoder_conf=conf["decoder_conf"],
                        model_conf=conf["model_conf"],
                        cmvn=GlobalCMVN(norm.mean, norm.istd))
    state = seeded_state_dict(model, 7)
    state["ctc.ctc_lo.weight"] *= 8.0
    upstream = dict(state)
    for i in (0, 11):
        upstream[f"encoder.encoders.{i}.concat_linear.weight"] = \
            torch.zeros(256, 512)
        upstream[f"encoder.encoders.{i}.concat_linear.bias"] = \
            torch.zeros(256)
    upstream["encoder.encoders.0.conv_module.norm.num_batches_tracked"] = \
        torch.tensor(100)
    upstream["encoder.global_cmvn.mean"] = torch.zeros(80)
    upstream["encoder.global_cmvn.istd"] = torch.ones(80)
    pt = os.path.join(root, "model.pt")
    torch.save(upstream, pt)
    bundle = convert_masr_checkpoint.main([
        "--configs", config_file(conf, os.path.join(root, "conf.yml")),
        "--torch_model", pt, "--save_model_path",
        os.path.join(root, "models")])
    check(bundle == os.path.join(root, "models", "conformer_streaming_fbank",
                                 "inference_model"), f"bundle at {bundle}")
    # the tool drops the global CMVN: the model has it from mean_istd_path
    load_upstream_state_dict(model, {k: v for k, v in upstream.items()
                                     if "global_cmvn" not in k})
    utts = wavs[:TOOLS_UTTERANCES]
    run = bundle_vs_model(bundle, model.to(dev), utts, dev, "conformer")
    check(run["err"] == 0.0, f"converted bundle's probs == the state dict's "
          f"model's on the card (max diff {run['err']})")
    check(run["launches"] == LAYER_LAUNCHES["conformer"], f"{run['launches']}"
          f" row-1 launches, want {LAYER_LAUNCHES['conformer']} per encode")
    # texts: no argmax flip past the near-tie margin (probs_card_vs_cpu)
    cpu = MASRPredictor(model_dir=bundle, device="cpu", warmup=False)
    err, _, _ = probs_card_vs_cpu(run["pred"], cpu, utts)
    equal = sum(a == r["text"] for a, r in
                zip(run["texts"], cpu.predict_batch(utts)))
    emit({"phase": "convert_checkpoint", "utterances": len(utts),
          "launches": run["launches"], "probs_card_vs_model": run["err"],
          "probs_card_vs_cpu": err, "texts_equal_cpu": equal,
          "bundle_bytes": run["bytes"],
          "seconds": time.perf_counter() - t0})
    return bundle


def phase_avg_checkpoints(dev, corpus, wavs):
    """`python -m masr_tpu_torch.tools.avg_checkpoints`'s main over phase
    12's last 3 epoch checkpoints (build/smoke/train): every floating
    tensor of the average == torch.stack(...).mean(0) of the three, the
    integer ones, the optimizer and the step counts epoch 3's; the average
    exported by the export_model CLI on the card predicts the 4 utterances
    with 12 row-1 launches, its probs == the averaged state's model's on
    the card; MASRTrainer.train(resume_model=avg) takes one step (12 + 12
    row-3 and 1 + 1 row-4 launches) on one batch of the corpus. → the
    exported bundle."""
    from masr_tpu_torch import export_model
    from masr_tpu_torch.data.normalizer import FeatureNormalizer
    from masr_tpu_torch.models.cmvn import GlobalCMVN
    from masr_tpu_torch.models.registry import build_model
    from masr_tpu_torch.tools import avg_checkpoints
    from masr_tpu_torch.training import checkpoints as ckpt
    from masr_tpu_torch.training.trainer import MASRTrainer
    t0 = time.perf_counter()
    run_dir = os.path.join(WORK, "train", "models",
                           "conformer_streaming_fbank")
    root = os.path.join(WORK, "avg")
    shutil.rmtree(root, ignore_errors=True)
    epochs = avg_checkpoints.list_epoch_checkpoints(run_dir)
    check([e for e, _ in epochs][-3:] == [1, 2, 3],
          f"phase 12 left epochs {[e for e, _ in epochs]}")
    avg = avg_checkpoints.main(["--checkpoints_dir", run_dir, "--num", "3",
                                "--output", os.path.join(root, "avg_model")])
    states = [ckpt.load_checkpoint(p)[0] for _, p in epochs[-3:]]
    got, meta = ckpt.load_checkpoint(avg)
    check(meta["averaged_from"] == ["epoch_1", "epoch_2", "epoch_3"],
          f"averaged_from {meta['averaged_from']}")
    n_float = 0
    for name, value in got["model"].items():
        xs = [s["model"][name] for s in states]
        if torch.is_floating_point(value):
            n_float += 1
            check(torch.equal(value, torch.stack(xs).mean(0)),
                  f"averaged {name} == the mean of the three")
        else:
            check(torch.equal(value, xs[-1]), f"{name} from epoch 3")
    check(got["step"] == states[-1]["step"] and
          str(got["optimizer"]) == str(states[-1]["optimizer"]),
          "step counts and optimizer from epoch 3")
    conf = train_config(corpus, root, TRAIN_EPOCHS + 2)
    cfg = config_file(conf, os.path.join(root, "conf.yml"))
    bundle = export_model.main(["--configs", cfg, "--resume_model", avg,
                                "--save_model_path",
                                os.path.join(root, "export")])
    norm = FeatureNormalizer(corpus["cmvn"])
    model = build_model("conformer", 80, VOCAB,
                        encoder_conf=conf["encoder_conf"],
                        decoder_conf=conf["decoder_conf"],
                        model_conf=conf["model_conf"],
                        cmvn=GlobalCMVN(norm.mean, norm.istd))
    model.load_state_dict(got["model"])
    utts = wavs[:TOOLS_UTTERANCES]
    run = bundle_vs_model(bundle, model.to(dev), utts, dev, "conformer")
    check(run["err"] == 0.0, f"averaged bundle's probs == the averaged "
          f"model's on the card (max diff {run['err']})")
    check(run["launches"] == LAYER_LAUNCHES["conformer"],
          f"{run['launches']} row-1 launches per encode")
    one = corpus_every(corpus, os.path.join(root, "one_batch"),
                       TRAIN_STEPS_PER_EPOCH)
    trainer = MASRTrainer(train_config(one, root, TRAIN_EPOCHS + 2),
                          device="cuda")
    reset_train_launches()
    trainer.train(save_model_path=os.path.join(root, "resumed"),
                  resume_model=avg, augment_conf_path=None)
    launches = train_launches()
    n = FLAGSHIP_ENCODER["num_blocks"]
    check(trainer.state.step == got["step"] + 1, f"resumed at step "
          f"{got['step']}, now {trainer.state.step}")
    # the step, then the test set's validation pass (forwards only)
    check(launches[1] == n and launches[3] == 1 and launches[0] >= 2 * n
          and launches[2] >= 2, f"one resumed step's launches {launches}")
    emit({"phase": "avg_checkpoints", "averaged": meta["averaged_from"],
          "float_tensors": n_float, "launches_predict": run["launches"],
          "probs_card_vs_model": run["err"], "texts": run["texts"],
          "resumed_step": trainer.state.step, "launches_resume": launches,
          "seconds": time.perf_counter() - t0})
    return bundle


def phase_tune(dev, corpus, bundle):
    """`python -m masr_tpu_torch.tools.tune`'s main on phase 60's converted
    bundle (the corpus's vocabulary; seeded weights, whose texts are not
    empty, where phase 12's three epochs still read blank), a 2x2 (alpha,
    beta) grid over the first 4 test utterances of phase 12's corpus with
    a character bigram ARPA of its training texts,
    twice: the host grid (BeamSearchDecoder), then --use_device (the beam
    on the card). Each run's cached probs come from row 1 (12 launches per
    utterance); each grid point's error == the same point decoded on the
    CPU from the card's cached probs (the host decoder, and the device
    beam on CPU tensors); the BEST line names a grid pair."""
    from masr_tpu_torch.data.manifest import read_manifest
    from masr_tpu_torch.data.text_featurizer import TextFeaturizer
    from masr_tpu_torch.decoders.beam_search import BeamSearchDecoder
    from masr_tpu_torch.decoders.device_beam import (build_dense_bigram,
                                                     decode_batch_device)
    from masr_tpu_torch.tools import tune
    from masr_tpu_torch.utils.metrics import cer
    t0 = time.perf_counter()
    root = os.path.join(WORK, "tune")
    shutil.rmtree(root, ignore_errors=True)
    texts = [e["text"] for e in read_manifest(corpus["train"])]
    lm = write_char_bigram_arpa(texts, os.path.join(root, "lm.arpa"))
    beam = dict(beam_size=10, cutoff_prob=0.99, cutoff_top_n=40,
                num_processes=4, language_model_path=lm)
    cfg = config_file({"preprocess_conf": PREPROCESS, "metrics_type": "cer",
                       "dataset_conf": {"test_manifest": corpus["test"]},
                       "ctc_beam_search_decoder_conf": beam},
                      os.path.join(root, "tune.yml"))
    vocab = TextFeaturizer(os.path.join(bundle, "vocabulary.txt")).vocab_list
    n = FLAGSHIP_ENCODER["num_blocks"]
    out = {}
    for mode in ("host", "device"):
        lines = []
        handler = logging.Handler()
        handler.emit = lambda r: lines.append(r.getMessage())
        logging.getLogger("masr_tpu_torch").addHandler(handler)
        reset_launches()
        t_run = time.perf_counter()
        try:
            res = tune.main(["--configs", cfg, "--model_dir", bundle,
                             "--num_utts", str(TOOLS_UTTERANCES),
                             "--num_alphas", "2", "--num_betas", "2",
                             "--alpha_from", "0.5", "--alpha_to", "2.5",
                             "--beta_from", "0.5", "--beta_to", "3.0",
                             "--use_device", str(mode == "device")])
        finally:
            logging.getLogger("masr_tpu_torch").removeHandler(handler)
        seconds = time.perf_counter() - t_run
        launches = layer_kernel("conformer").launches
        check(launches == n * TOOLS_UTTERANCES, f"tune {mode}: {launches} "
              f"row-1 launches, want {n} x {TOOLS_UTTERANCES} utterances")
        cached = res["cached"]
        if mode == "device":
            T = max(p.shape[0] for p, _ in cached)
            probs = torch.zeros(len(cached), T, cached[0][0].shape[1])
            for i, (p, _) in enumerate(cached):
                probs[i, :p.shape[0]] = torch.from_numpy(p)
            lens = torch.tensor([p.shape[0] for p, _ in cached])
            table = torch.from_numpy(build_dense_bigram(lm, vocab))
        for alpha, beta, e in res["grid"]:
            if mode == "device":
                hyps = decode_batch_device(probs, lens, vocab, beam_size=10,
                                           cutoff_top_n=40, lm_table=table,
                                           alpha=alpha, beta=beta)
            else:
                hyps = BeamSearchDecoder(
                    vocab, alpha=alpha, beta=beta, beam_size=10,
                    cutoff_prob=0.99, cutoff_top_n=40, num_processes=4,
                    language_model_path=lm).decode_batch_beam_search_offline(
                        [p for p, _ in cached])
            want = float(np.mean([cer(t, h) for (_, t), (_, h) in
                                  zip(cached, hyps)]))
            check(e == want, f"tune {mode} alpha={alpha} beta={beta}: card "
                  f"{e}, CPU from the cached probs {want}")
        best = [l for l in lines if l.startswith("BEST:")]
        pairs = [f"BEST: alpha={a:.2f}, beta={b:.2f}, cer={e:.5f}"
                 for a, b, e in res["grid"]]
        check(len(best) == 1 and best[0] in pairs, f"tune {mode}: {best} "
              f"names a grid pair")
        out[mode] = {"grid": res["grid"], "best": best[0],
                     "launches": launches, "seconds": seconds}
    emit({"phase": "tune", "utterances": TOOLS_UTTERANCES, **out,
          "seconds": time.perf_counter() - t0})
    return out


@contextlib.contextmanager
def counted_dispatches(store):
    """Appends one entry to `store` per BatchStreamSession dispatch."""
    from masr_tpu_torch.infer.batch_stream import BatchStreamSession
    orig = BatchStreamSession._dispatch

    def dispatch(self, *a, **k):
        store.append(1)
        return orig(self, *a, **k)

    BatchStreamSession._dispatch = dispatch
    try:
        yield store
    finally:
        BatchStreamSession._dispatch = orig


def phase_soak_stream(dev, stream_path):
    """`python -m masr_tpu_torch.tools.soak_stream`'s main on the flagship
    stream bundle (phase 7's), 2 streams, SOAK_MINUTES simulated minutes,
    a position table of SOAK_POS_TABLE rows so that the streams cross its
    horizon in the first minute: past_horizon, partials_sane and every
    minute's partial not empty; 12 row-2 launches per dispatch;
    torch.cuda.memory_allocated() read after each minute grows by at most
    SOAK_MEMORY_BOUND bytes after the first. → row-2 launches."""
    from masr_tpu_torch.tools import soak_stream
    t0 = time.perf_counter()
    memory = []

    def read_memory(row):
        torch.cuda.synchronize()
        memory.append(torch.cuda.memory_allocated())

    dispatches = []
    reset_launches()
    with counted_dispatches(dispatches):
        res = soak_stream.main(["--model_dir", stream_path, "--minutes",
                                str(SOAK_MINUTES), "--streams", "2",
                                "--pos_table_len", str(SOAK_POS_TABLE)],
                               on_minute=read_memory)
    launches = chunk_launches()
    rows, s = res["rows"], res["summary"]
    n = CHUNK_LAUNCHES["conformer"]
    check(dispatches and launches == n * len(dispatches), f"soak: {launches} "
          f"row-2 launches over {len(dispatches)} dispatches, want {n} each")
    check(s["crossed_horizon"] and rows[0]["past_horizon"], "soak crossed "
          "the position-table horizon in its first minute")
    check(s["partials_sane"] and all(r["partial_len"] > 0 for r in rows),
          f"soak partials {[r['partial_len'] for r in rows]}")
    growth = max(memory[1:]) - memory[0]
    check(growth <= SOAK_MEMORY_BOUND, f"device memory after each minute "
          f"{memory}: grew {growth} bytes after the first")
    emit({"phase": "soak_stream", "minutes": SOAK_MINUTES, "streams": 2,
          "rows": rows, "summary": s, "dispatches": len(dispatches),
          "launches": launches, "device_memory_bytes": memory,
          "memory_growth_bytes": growth,
          "memory_bound_bytes": SOAK_MEMORY_BOUND,
          "seconds": time.perf_counter() - t0})
    return launches


def gui_replay(pred, wav, block):
    """The GUI's calls in this thread: predict_stream over blocks with
    is_end False, then an empty is_end True → stream()'s dict."""
    top2, text = [], None
    with record_top2(top2):
        for i in range(0, len(wav), block):
            r = pred.predict_stream(wav[i:i + block], is_end=False)
            text = r["text"] if r is not None else text
        r = pred.predict_stream(np.zeros(0, np.float32), is_end=True)
        text = r["text"] if r is not None else text
    dec = pred.greedy_chunk_decoder
    ids = np.asarray(dec._max_index)
    out = {"text": text, "ids": ids,
           "top2": np.concatenate([t[0] for t in top2])[:len(ids)]}
    pred.reset_stream()
    return out


def phase_gui_stream(dev, stream_path, corpus):
    """The GUI's controller (masr_tpu_torch/infer/gui_app.py) on the card:
    a StreamingRecognizer over MASRPredictor(stream bundle, device=cuda),
    fed by FileSource of one corpus utterance (not real time), its
    capture and consumer threads running: the last partial == the same
    calls replayed in this thread (bits: the same windows), which ==
    predict_stream(whole, is_end=True)'s text by same_text's rule; 12 row-2
    launches per window; on_log received nothing but the save message;
    the saved recording's PCM == the input's. → row-2 launches."""
    from masr_tpu_torch.audio import AudioSegment
    from masr_tpu_torch.data.manifest import read_manifest
    from masr_tpu_torch.infer.gui_app import FileSource, StreamingRecognizer
    from masr_tpu_torch.infer.predictor import MASRPredictor
    t0 = time.perf_counter()
    root = os.path.join(WORK, "gui")
    shutil.rmtree(root, ignore_errors=True)
    entry = read_manifest(corpus["test"])[-1]
    wav = AudioSegment.from_file(entry["audio_filepath"]).samples
    pred = MASRPredictor(model_dir=stream_path, device=dev)
    steps = count_chunk_steps(pred)
    partials, logs = [], []
    rec = StreamingRecognizer(pred, output_path=os.path.join(root, "record"),
                              on_partial=lambda t, s: partials.append(t),
                              on_log=logs.append)
    reset_launches()
    t_rec = time.perf_counter()
    rec.start(FileSource(wav))
    deadline = time.time() + 120
    while rec.recording and time.time() < deadline:
        time.sleep(0.01)
    check(not rec.recording, "the file source drained within 120 s")
    saved = rec.stop(save=True)
    seconds = time.perf_counter() - t_rec
    launches, windows = chunk_launches(), len(steps)
    n = CHUNK_LAUNCHES["conformer"]
    check(windows > 0 and launches == n * windows, f"gui: {launches} row-2 "
          f"launches over {windows} windows, want {n} each")
    # stop() joined both threads, then logged the saved path: an error
    # that the consumer caught would stand before it
    check(len(logs) == 1 and saved in logs[0], f"on_log received {logs}")
    check(bool(partials), "partials streamed")
    replay = gui_replay(pred, wav, rec.block_size)
    check(partials[-1] == replay["text"], f"recognizer text "
          f"{partials[-1]!r} == the same calls in this thread "
          f"{replay['text']!r}")
    whole = stream(pred, wav)
    margin = same_text(replay, whole, "gui stream vs predict_stream whole")
    pcm = (np.clip(wav, -1.0, 1.0) * 32767.0).astype("<i2")
    import wave
    with wave.open(saved, "rb") as f:
        got = np.frombuffer(f.readframes(f.getnframes()), "<i2")
        rate = f.getframerate()
    check(rate == 16000 and np.array_equal(got, pcm),
          f"saved recording {saved} holds the input's PCM")
    emit({"phase": "gui_stream", "seconds_audio": len(wav) / 16000,
          "partials": len(partials), "text": partials[-1],
          "text_equals_whole": margin is None, "windows": windows,
          "launches": launches, "recognize_s": seconds,
          "seconds": time.perf_counter() - t0})
    return launches


# --------------------------------------------------------------------------- #
# slice 16: the subsamplings on the kernel route, the eager routes, the
# smaller gaps
# --------------------------------------------------------------------------- #
SUBSAMPLINGS = ("conv2d8", "conv2d6", "linear")
EAGER_ATOL = 1e-3   # eager encoder rows card vs CPU: 12 layers of f32 sums
#                     in other orders, the card's attention through row 5
# rows whose wrappers the eager routes must not reach (row 4, the CTC
# loss, and row 5, the flash attention of an eager rel-pos layer, may)
LAYER_ROWS = ("conformer_layer", "chunk_layer", "conformer_layer_train",
              "squeezeformer_layer", "squeezeformer_layer_train",
              "chunk_layer_sq")


@contextlib.contextmanager
def plain_twins():
    """The Conformer's rows 1-4 swapped for their plain twins inside the
    model code (models/conformer.py, models/losses.py), so that a path
    runs on the card without a kernel: the reference a kernel-route run is
    held against."""
    from masr_tpu_torch.models import conformer as mc
    from masr_tpu_torch.models import losses
    from masr_tpu_torch.ops.cuda import chunk_layer as ck
    from masr_tpu_torch.ops.cuda import conformer_layer as cl
    from masr_tpu_torch.ops.cuda import conformer_layer_train as clt
    from masr_tpu_torch.ops.cuda import ctc_loss as C
    swaps = [(mc, "fused_conformer_layer", cl.fused_conformer_layer_plain),
             (mc, "fused_chunk_layer", ck.fused_chunk_layer_plain),
             (mc, "fused_conformer_layer_train",
              clt.fused_conformer_layer_train_plain),
             (losses, "ctc_loss", C.ctc_loss_plain)]
    saved = [(m, n, getattr(m, n)) for m, n, _ in swaps]
    for m, n, fn in swaps:
        setattr(m, n, fn)
    try:
        yield
    finally:
        for m, n, fn in saved:
            setattr(m, n, fn)


def slice_texts(vocab, n=8):
    """The label ids of synthetic_texts (B, L) padded with -1, and their
    lengths."""
    ids = [[vocab.index(ch) for ch in text]
           for text, _ in synthetic_texts(vocab)[:n]]
    L = max(len(t) for t in ids)
    text = torch.full((len(ids), L), -1, dtype=torch.long)
    for i, t in enumerate(ids):
        text[i, :len(t)] = torch.tensor(t)
    return text, torch.tensor([len(t) for t in ids])


def train_step_on(model, speech, lens, text, tlens, dev, seed=7):
    """One loss and backward of `model` in train mode on `dev` (its
    dropouts and dynamic chunk drawn from seeded generators) → (loss,
    {name: grad}); the grads are cleared after."""
    model.train()
    out = model(speech.to(dev), lens.to(dev), text.to(dev), tlens.to(dev),
                generator=torch.Generator(dev).manual_seed(seed),
                chunk_generator=torch.Generator().manual_seed(seed))
    out["loss"].backward()
    grads = {k: p.grad.detach().clone() for k, p in model.named_parameters()
             if p.grad is not None}
    model.zero_grad(set_to_none=True)
    model.eval()
    return float(out["loss"].detach()), grads


def grad_err(got, want):
    """The grads' max abs difference over every parameter, relative to the
    largest grad of any (a parameter whose true grad is 0, as a key
    projection's bias under the softmax, holds f32 noise alone) → (err,
    the parameter that sets it)."""
    scale = max(w.abs().max().item() for w in want.values())
    name = max(want, key=lambda k: (got[k] - want[k]).abs().max().item())
    return (got[name] - want[name]).abs().max().item() / scale, name


def layer0_inputs(model, speech, lens):
    """The first encoder layer's inputs of a full-context encode: (x (B,
    T', D), lens (B,), pos_emb (1, T', D))."""
    from masr_tpu_torch.ops.masks import make_pad_mask
    enc = model.encoder
    with torch.no_grad():
        masks = ~make_pad_mask(lens, speech.shape[1])[:, None, :]
        x, pos_emb, masks = enc.embed(enc._features(speech), masks)
    return x, masks[:, 0, :].sum(dim=1, dtype=torch.int32), pos_emb


def phase_subsampling_kernels(dev, wavs, smi):
    """configs/conformer.yml's widths (12 blocks, causal, rel_pos, swish)
    with input_layer conv2d8, conv2d6 and linear in turn: layer_route
    "kernel"; predict_batch of the 8 utterances (12 row-1 launches), a
    chain of 4 chunk dispatches at B=32 through forward_chunk_batched (12
    row-2 launches each) and one train step at B=8 (12 + 12 row-3 and 1 +
    1 row-4 launches), each held against the same path through the plain
    twins on the card (probs PROBS_ATOL; loss rel 1e-5 and grads 10 x
    GRAD_RTOL of the largest grad, grad_err); row 1 and row 3 vs their
    twins at layer 0's
    real inputs (KERNEL_ATOL, GRAD_RTOL) and timed (CUDA events), with the
    step's peak device memory above what was live when it began."""
    from masr_tpu_torch.infer.predictor import MASRPredictor
    from masr_tpu_torch.ops.cuda import conformer_layer as cl
    from masr_tpu_torch.ops.cuda import conformer_layer_train as clt
    from masr_tpu_torch.ops.masks import add_optional_chunk_mask
    rows, totals = [], {"row1": 0, "row2": 0, "row3": 0, "row4": 0}
    for layer_name in SUBSAMPLINGS:
        path = os.path.join(WORK, f"conformer_{layer_name}_bundle")
        vocab = write_flagship_bundle(path, encoder=dict(
            input_layer=layer_name))
        gpu = MASRPredictor(model_dir=path, device=dev, warmup=False)
        model = gpu.predictor.model
        enc = model.encoder
        check(enc.layer_route == "kernel", f"{layer_name}: kernel route")
        rate, right = enc.embed.subsampling_rate, enc.embed.right_context
        # offline: predict_batch, counted alone
        reset_all_launches()
        t0 = time.perf_counter()
        gpu.predict_batch(wavs)
        wall = time.perf_counter() - t0
        n1 = all_launches()["conformer_layer"]
        check(n1 == 12, f"{layer_name}: {n1} row-1 launches == 12 a "
              "predict_batch encode")
        totals["row1"] += n1
        speech, lens = gpu.featurize_batch(wavs)
        p_k, l_k = gpu.predictor.predict(speech, lens)
        with plain_twins():
            p_p, _ = gpu.predictor.predict(speech, lens)
        probs_err = max(float(np.abs(p_k[b, :n] - p_p[b, :n]).max())
                        for b, n in enumerate(l_k))
        check(np.isfinite(p_k).all() and probs_err <= PROBS_ATOL,
              f"{layer_name}: probs kernel vs plain {probs_err}")
        sp, ln = torch.from_numpy(speech).to(dev), torch.from_numpy(lens).to(
            dev)
        x, l0, pos_emb = layer0_inputs(model, sp, ln)
        layer = enc.encoders[0]
        with torch.no_grad():
            pos_p = layer.self_attn.linear_pos(pos_emb[0])
            y_k = run_layer(cl.fused_conformer_layer, layer, x, l0, pos_p)
            y_p = run_layer(cl.fused_conformer_layer_plain, layer, x, l0,
                            pos_p)
        row1_err = max((y_k[b, :n] - y_p[b, :n]).abs().max().item()
                       for b, n in enumerate(l0.tolist()) if n)
        check(row1_err <= KERNEL_ATOL, f"{layer_name}: row 1 vs plain "
              f"{row1_err} at T'={x.shape[1]}")
        with torch.no_grad():
            row1_ms = cuda_ms(lambda: run_layer(
                cl.fused_conformer_layer, layer, x, l0, pos_p))
            row1_plain_ms = cuda_ms(lambda: run_layer(
                cl.fused_conformer_layer_plain, layer, x, l0, pos_p))
        # streaming: 4 dispatches at B=32 of 16-frame chunks
        win = (CHUNK - 1) * rate + right + 1
        feats = torch.from_numpy(speech)
        starts = [(s * 7) % max(1, feats.shape[1] - 4 * win) for s in range(32)]
        chain = {}
        for route in ("kernel", "plain"):
            state = enc.init_cache(batch=32, cache_size=CACHE, device=dev)
            packed = enc.pack_chunk_params(CACHE)
            outs, launches = [], []
            ctx = plain_twins() if route == "plain" else contextlib.nullcontext()
            with ctx:
                for k in range(4):
                    w = torch.stack([feats[s % len(feats), st + k * CHUNK * rate:
                                           st + k * CHUNK * rate + win]
                                     for s, st in enumerate(starts)]).to(dev)
                    reset_all_launches()
                    with torch.no_grad():
                        outs.append(model.ctc.softmax(
                            enc.forward_chunk_batched(w, state, packed)))
                    torch.cuda.synchronize()
                    launches.append(all_launches()["chunk_layer"])
            chain[route] = (torch.cat(outs, 1), launches)
        check(chain["kernel"][1] == [12] * 4 and chain["plain"][1] == [0] * 4,
              f"{layer_name}: row-2 launches a dispatch {chain['kernel'][1]}")
        totals["row2"] += sum(chain["kernel"][1])
        chunk_err = (chain["kernel"][0] - chain["plain"][0]).abs().max().item()
        check(chunk_err <= PROBS_ATOL, f"{layer_name}: chunk chain probs "
              f"kernel vs plain {chunk_err}")
        # training: one step at B=8, dropout 0, kernel vs plain twins
        text, tlens = slice_texts(vocab, len(wavs))
        tconf = dict(FLAGSHIP_ENCODER, input_layer=layer_name,
                     dropout_rate=0.0, positional_dropout_rate=0.0,
                     attention_dropout_rate=0.0)
        from masr_tpu_torch.models.registry import build_model
        tm = build_model("conformer", 80, VOCAB, streaming=True,
                         encoder_conf=tconf, model_conf=dict(ctc_weight=1.0))
        tm.load_state_dict({k: v for k, v in model.state_dict().items()
                            if not k.startswith("decoder.")}, strict=False)
        tm = tm.to(dev)
        reset_all_launches()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        loss_k, g_k = train_step_on(tm, sp, ln, text, tlens, dev)
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t0
        # the step's own peak: above what was live when it began
        peak = torch.cuda.max_memory_allocated() - before
        got = train_launches("conformer")
        check(got == (24, 12, 2, 1), f"{layer_name}: train step launches "
              f"(row 3, its backward, row 4, its backward) {got} == "
              "(24, 12, 2, 1)")
        totals["row3"] += got[0]
        totals["row4"] += got[2]
        with plain_twins():
            loss_p, g_p = train_step_on(tm, sp, ln, text, tlens, dev)
        loss_rel = abs(loss_k - loss_p) / abs(loss_p)
        grad_rel, grad_at = grad_err(g_k, g_p)
        check(np.isfinite(loss_k) and loss_rel <= 1e-5, f"{layer_name}: "
              f"train loss kernel vs plain rel {loss_rel}")
        check(grad_rel <= 10 * GRAD_RTOL, f"{layer_name}: grads kernel vs "
              f"plain {grad_rel} (at {grad_at}) <= {10 * GRAD_RTOL} of the "
              "largest grad")
        # row 3 at layer 0's real training shape (a 16-frame chunk mask)
        tl = tm.encoder.encoders[0]
        xt, lt, pt = layer0_inputs(tm, sp, ln)
        mask = add_optional_chunk_mask(xt.shape[1], (torch.arange(
            xt.shape[1], device=dev)[None] < lt[:, None])[:, None], True,
            False, 16, 0, 4)
        g = torch.Generator().manual_seed(3)
        with torch.no_grad():
            posp = tl.self_attn.linear_pos(pt[0])
            packed = {k: v.clone() for k, v in tl.packed_params().items()}
        args = (xt.detach(), torch.randn(xt.shape, generator=g).to(dev),
                mask, torch.zeros(xt.shape[0], dtype=torch.int32,
                                  device=dev), lt, posp, packed)
        fns = (clt.fused_conformer_layer_train,
               clt.fused_conformer_layer_train_plain)
        case = check_train_layer(fns, tl, args, (0.0, 0.0))
        fwd, bwd = time_train_layer({"kernel": fns[0], "plain": fns[1]}, tl,
                                    args, (0.0, 0.0))
        t3 = {"ms": min(fwd["kernel"]) + min(bwd["kernel"]),
              "plain_ms": min(fwd["plain"]) + min(bwd["plain"]),
              "fwd_ms": fwd["kernel"], "bwd_ms": bwd["kernel"],
              **train_layer_bound(tl, args)}
        # row 4 at this loss shape: the CTC head's logits of layer 0's
        # lengths, forward + backward, kernel vs plain
        from masr_tpu_torch.ops.cuda import ctc_loss as C
        lg = (8 * torch.randn(xt.shape[0], xt.shape[1], VOCAB,
                              generator=g)).to(dev)
        tl_d, tx_d = tlens.to(dev).int(), text.to(dev).int()

        def ctc_run(fn):
            x = lg.clone().requires_grad_(True)
            fn(x, lt, tx_d, tl_d).sum().backward()

        t4 = {"ms": cuda_ms(lambda: ctc_run(C.ctc_loss), iters=5),
              "plain_ms": cuda_ms(lambda: ctc_run(C.ctc_loss_plain),
                                  iters=2, warm=1), **ctc_bound(lg)}
        # one dispatch of 12 chunk layers, kernel vs plain (B=32, c=16)
        state = enc.init_cache(batch=32, cache_size=CACHE, device=dev)
        packed = enc.pack_chunk_params(CACHE)
        w0 = w.clone()
        with torch.no_grad():
            d_k = cuda_ms(lambda: enc.forward_chunk_batched(w0, state,
                                                             packed), iters=5)
            with plain_twins():
                d_p = cuda_ms(lambda: enc.forward_chunk_batched(
                    w0, state, packed), iters=5)
        rows.append({
            "input_layer": layer_name, "rate": rate, "right_context": right,
            "T_out": int(x.shape[1]), "predict_batch_s": wall,
            "row1": {"launches": n1, "max_abs_err": row1_err,
                     "ms": row1_ms, "plain_ms": row1_plain_ms,
                     **layer_bound(layer, l0.tolist(), x.shape[1])},
            "probs_kernel_vs_plain": probs_err,
            "row2": {"launches": chain["kernel"][1], "window": win,
                     "probs_kernel_vs_plain": chunk_err,
                     "dispatch_ms": d_k, "plain_dispatch_ms": d_p},
            "row3": {"launches": got[0], "T": case["T"],
                     "max_abs_err": case["max_abs_err"],
                     "grad_rel_err": max(case["grad_rel_err"].values()),
                     **t3},
            "row4": {"launches": got[2], **t4}, "train_step_s": step_s,
            "train_step_peak_bytes": peak, "loss": loss_k,
            "loss_rel_kernel_vs_plain": loss_rel,
            "grad_rel_kernel_vs_plain": grad_rel, "grad_worst_at": grad_at})
        del tm, gpu, model
        torch.cuda.empty_cache()
    emit({"phase": "subsampling_kernels", "card": smi,
          "atol": KERNEL_ATOL, "probs_atol": PROBS_ATOL, "cases": rows})
    return totals


def eager_run(dev, family, encoder, wavs):
    """One eager-route model of `family` with `encoder` overrides: card
    predict_batch, a 4-window chunk chain at B=8 and a train step, each
    against the CPU → result dict (checks raise)."""
    from masr_tpu_torch.infer.predictor import MASRPredictor
    from masr_tpu_torch.models.registry import build_model
    name = f"{family}_eager"
    path = os.path.join(WORK, f"{name}_bundle")
    vocab = write_flagship_bundle(path, family, encoder=encoder)
    gpu = MASRPredictor(model_dir=path, device=dev, warmup=False)
    cpu = MASRPredictor(model_dir=path, device="cpu", warmup=False)
    check(gpu.predictor.model.encoder.layer_route == "eager",
          f"{name}: eager route")
    reset_all_launches()
    gpu.predict_batch(wavs)
    offline = all_launches()
    check(not any(offline[r] for r in LAYER_ROWS), f"{name}: no layer "
          f"kernel in predict_batch ({offline})")
    speech, lens = gpu.featurize_batch(wavs)
    sp, ln = torch.from_numpy(speech), torch.from_numpy(lens)
    with torch.no_grad():
        h_g, m_g = gpu.predictor.model.encoder(sp.to(dev), ln.to(dev))
        h_c, m_c = cpu.predictor.model.encoder(sp, ln)
        p_g = gpu.predictor.model.ctc.softmax(h_g).cpu()
        p_c = cpu.predictor.model.ctc.softmax(h_c)
    n_out = m_c[:, 0].sum(1)
    check(torch.equal(m_g[:, 0].sum(1).cpu(), n_out), f"{name}: lengths")
    enc_err = probs_err = 0.0
    flips = compared = 0
    for b, n in enumerate(n_out.tolist()):
        enc_err = max(enc_err, (h_g[b, :n].cpu() - h_c[b, :n]).abs().max()
                      .item())
        probs_err = max(probs_err, (p_g[b, :n] - p_c[b, :n]).abs().max()
                        .item())
        top2 = p_c[b, :n].topk(2, dim=-1).values
        sure = top2[:, 0] - top2[:, 1] > ARGMAX_MARGIN
        flips += int((p_g[b, :n].argmax(-1) != p_c[b, :n].argmax(-1))[sure]
                     .sum())
        compared += int(sure.sum())
    t_out = int(h_g.shape[1])
    check(bool(torch.isfinite(h_g).all()), f"{name}: encoder rows finite")
    check(enc_err <= EAGER_ATOL, f"{name}: encoder rows card vs CPU "
          f"{enc_err} <= {EAGER_ATOL}")
    check(probs_err <= PROBS_ATOL and flips == 0, f"{name}: probs card vs "
          f"CPU {probs_err} <= {PROBS_ATOL}, {flips} argmax flips past the "
          "margin")
    # streaming: 4 windows of each of the 8 utterances, B=8
    win = (CHUNK - 1) * 4 + 7
    outs = {}
    for where, pred, d in (("card", gpu, dev), ("cpu", cpu, "cpu")):
        enc = pred.predictor.model.encoder
        state = enc.init_cache(batch=sp.shape[0], cache_size=CACHE, device=d)
        packed = enc.pack_chunk_params(CACHE)
        check(packed is None and not enc.multi_chunk,
              f"{name}: eager chunk step packs nothing")
        ys = []
        reset_all_launches()
        for k in range(4):
            w = sp[:, k * CHUNK * 4:k * CHUNK * 4 + win].to(d)
            with torch.no_grad():
                ys.append(enc.forward_chunk_batched(w, state, packed).cpu())
        if where == "card":
            stream_launches = all_launches()
        outs[where] = torch.cat(ys, 1)
    check(not any(stream_launches[r] for r in LAYER_ROWS),
          f"{name}: no layer kernel in the chunk chain ({stream_launches})")
    chunk_err = (outs["card"] - outs["cpu"]).abs().max().item()
    check(chunk_err <= EAGER_ATOL, f"{name}: chunk chain card vs CPU "
          f"{chunk_err} <= {EAGER_ATOL}")
    # training: one step, dropout 0, the CTC loss alone, card vs CPU
    text, tlens = slice_texts(vocab, len(wavs))
    base = dict({"conformer": FLAGSHIP_ENCODER,
                 "squeezeformer": SQ_ENCODER}[family], **encoder)
    zero = {"conformer": dict(dropout_rate=0.0, positional_dropout_rate=0.0,
                              attention_dropout_rate=0.0),
            "squeezeformer": dict(dropout=0.0, attention_dropout_rate=0.0,
                                  input_dropout_rate=0.0)}[family]
    losses, grads = {}, {}
    for where, d in (("card", dev), ("cpu", "cpu")):
        tm = build_model(family, 80, VOCAB, streaming=True,
                         encoder_conf=dict(base, **zero),
                         model_conf=dict(ctc_weight=1.0))
        tm.load_state_dict({k: v for k, v in
                            gpu.predictor.model.state_dict().items()
                            if not k.startswith("decoder.")}, strict=False)
        no_positional_dropout(tm)
        tm = tm.to(d)
        reset_all_launches()
        losses[where], grads[where] = train_step_on(tm, sp, ln, text, tlens,
                                                    d)
        if where == "card":
            torch.cuda.synchronize()
            train_l = all_launches()
            ctc_b = train_launches(family)[3]
    check(not any(train_l[r] for r in LAYER_ROWS) and
          train_l["ctc_loss"] == 2 and ctc_b == 1, f"{name}: a train step "
          f"launches row 4 once each way and no layer kernel ({train_l})")
    loss_rel = abs(losses["card"] - losses["cpu"]) / abs(losses["cpu"])
    grad_rel, grad_at = grad_err({k: v.cpu() for k, v in
                                  grads["card"].items()}, grads["cpu"])
    check(loss_rel <= 1e-4 and grad_rel <= 1e-2, f"{name}: train step card "
          f"vs CPU loss rel {loss_rel} <= 1e-4, grads {grad_rel} (at "
          f"{grad_at}) <= 1e-2 of the largest grad")
    return {"model": name, "encoder": encoder, "layer_route": "eager",
            "predict_batch_launches": offline, "T_out": t_out,
            "probs_max_abs_err": probs_err, "argmax_frames": compared,
            "encoder_rows_max_abs_err": enc_err,
            "chunk_launches": stream_launches, "chunk_max_abs_err": chunk_err,
            "train_launches": train_l, "loss_card": losses["card"],
            "loss_rel_card_vs_cpu": loss_rel,
            "grad_rel_card_vs_cpu": grad_rel, "grad_worst_at": grad_at}


def phase_eager_routes(dev, wavs, smi):
    """configs/conformer.yml's widths with activation relu, a BatchNorm
    conv module and post-norm layers, and a pre-norm Squeezeformer of
    configs/squeezeformer.yml: layer_route "eager", predict_batch, a chunk
    chain and a train step on the card, none reaching rows 1, 2, 3, 6, 7
    or 8, the step launching row 4 once each way; the card against the
    CPU: probs (PROBS_ATOL, no argmax flip past the margin), encoder rows
    and chunk outputs (EAGER_ATOL), the step's loss (rel 1e-4) and grads
    (1e-2 of the model's largest grad, grad_err: a BatchNorm's batch
    statistics and ReLU's derivative leave the f32 sums' order visible)."""
    runs = [eager_run(dev, "conformer", dict(
                activation_type="relu", cnn_module_norm="batch_norm",
                normalize_before=False), wavs),
            eager_run(dev, "squeezeformer", dict(normalize_before=True),
                      wavs)]
    emit({"phase": "eager_routes", "card": smi, "eager_atol": EAGER_ATOL,
          "probs_atol": PROBS_ATOL, "runs": runs})
    # row 5's launches on these main paths: the eager rel-pos attention of
    # each predict_batch encode
    return sum(r["predict_batch_launches"]["rel_pos_attention"]
               for r in runs)


def phase_small_gaps(dev, corpus, wavs, smi):
    """mfcc_torch and argmax_decode on the card against the host's
    mfcc_numpy (a frame's unliftered error within √80 · 1e-3: phase 43's
    1e-3 a log-mel bin through the orthonormal DCT) and
    greedy_decoder_batch (texts equal, scores rel 1e-5); then a 2-block flagship MASRTrainer on the
    card with
    train_conf.profile_batches [1, 2], stopped after 3 batches: the trace
    file it writes (Chrome's format) holds the card's kernels."""
    from masr_tpu_torch.decoders.greedy import (argmax_decode,
                                                greedy_decoder_batch)
    from masr_tpu_torch.ops.fbank import (lifter_coeffs, mfcc_numpy,
                                          mfcc_torch)
    from masr_tpu_torch.training import trainer as tr
    wav = [w * 32768.0 for w in wavs]
    S = max(len(w) for w in wav)
    batch = torch.zeros(len(wav), S)
    for i, w in enumerate(wav):
        batch[i, :len(w)] = torch.from_numpy(w)
    lens = torch.tensor([len(w) for w in wav], dtype=torch.int32)
    feats, flens = mfcc_torch(batch.to(dev), lens.to(dev))
    # the host's numpy FFT sums in f64, the card's cuFFT in f32: held to
    # phase 43's log-mel rule (1e-3 a bin) carried through the lifter and
    # the orthonormal DCT, a frame's unliftered error within √80 · 1e-3
    lift = lifter_coeffs(40, 22.0)
    mfcc_err = mfcc_l2 = 0.0
    for i, w in enumerate(wav):
        host = mfcc_numpy(w.astype(np.float32))
        n = int(flens[i])
        check(n == host.shape[0], f"mfcc frames {n} == {host.shape[0]}")
        diff = feats[i, :n].cpu().numpy() - host
        mfcc_err = max(mfcc_err, float(np.abs(diff).max()))
        mfcc_l2 = max(mfcc_l2, float(np.linalg.norm(diff / lift,
                                                    axis=1).max()))
    check(mfcc_l2 <= np.sqrt(80) * 1e-3, f"mfcc card vs host: a frame's "
          f"unliftered error {mfcc_l2} <= sqrt(80) x 1e-3")
    g = torch.Generator().manual_seed(9)
    logits = torch.randn(8, 300, VOCAB, generator=g) * 4
    logits[:, ::3, 0] += 8.0
    probs = torch.softmax(logits, -1)
    plens = torch.tensor([300, 280, 250, 200, 150, 100, 33, 0])
    tokens, counts, scores = argmax_decode(probs.to(dev), plens.to(dev))
    torch.cuda.synchronize()
    vocab = [f"<{i}>" for i in range(VOCAB)]
    host = greedy_decoder_batch(probs.numpy(), vocab, lens=plens.numpy())
    for b, (score, text) in enumerate(host):
        ids = tokens[b, :int(counts[b])].tolist()
        check(text == "".join(vocab[i] for i in ids), f"argmax_decode "
              f"utterance {b} == greedy_decoder_batch")
        check(abs(score - float(scores[b])) <= 1e-5 * max(1.0, abs(score)),
              f"argmax_decode score {b}")
    root = os.path.join(WORK, "profile_train")
    shutil.rmtree(root, ignore_errors=True)
    conf = train_config(corpus, root, 1, dropout=False)
    conf["encoder_conf"] = dict(conf["encoder_conf"], num_blocks=2)
    conf["train_conf"]["profile_batches"] = [1, 2]
    trainer = tr.MASRTrainer(conf, device=dev)
    orig, steps = tr.train_step, []

    def counted(*a, **kw):
        out = orig(*a, **kw)
        steps.append(1)
        if len(steps) == 3:
            trainer.stop_train = True
        return out

    tr.train_step = counted
    try:
        trainer.train(save_model_path=os.path.join(root, "models"),
                      augment_conf_path=None)
    finally:
        tr.train_step = orig
    trace = os.path.join(root, "log", "profile", "trace.json")
    check(os.path.exists(trace), f"profile trace written at {trace}")
    with open(trace, encoding="utf-8") as f:
        events = json.load(f)["traceEvents"]
    cats = {}
    for e in events:
        cats[e.get("cat", "")] = cats.get(e.get("cat", ""), 0) + 1
    kernels = cats.get("kernel", 0)
    check(kernels > 0, f"the trace holds the card's kernels ({cats})")
    emit({"phase": "small_gaps", "card": smi, "mfcc_max_abs_err": mfcc_err,
          "mfcc_frame_l2_unliftered": mfcc_l2,
          "mfcc_frames": flens.tolist(),
          "argmax_decode": {"utterances": len(host),
                            "tokens": counts.tolist()},
          "profile": {"steps_run": len(steps), "trace_bytes":
                      os.path.getsize(trace), "event_categories": cats}})


# phase 68: data and tensor parallelism. Two ranks share the one card
# over gloo (NCCL refuses two ranks on one device); the trainer's NCCL
# path runs in this process with a world of one.
PARALLEL_RANK_ROWS, PARALLEL_STEPS = 8, 2
# Adam's first steps move each parameter by about its rate (WarmupLR 8:
# 1.25e-5, then 2.5e-5) whatever the size of its grad, so an element whose
# grad lies within rounding of 0 may step either way: a parameter may
# differ by up to two such steps of opposite sign (7.5e-5) without a
# fault. Gated so: the first update's grads (the ranks' mean) per tensor
# within GRAD_RTOL of its largest grad (+ GRAD_ATOL), every parameter
# within PARAM_ATOL, and each tensor's mean difference under PARAM_MEAN,
# which one wrong update of either step passes only if it moves fewer
# than 8% of the tensor's elements (1e-6 / 1.25e-5).
PARALLEL_OPT = dict(optimizer="Adam", weight_decay=1e-6, learning_rate=1e-4,
                    scheduler="WarmupLR",
                    scheduler_conf=dict(warmup_steps=8, min_lr=1e-5))
PARALLEL_GRAD_RTOL, PARALLEL_GRAD_ATOL = 1e-4, 1e-7
PARALLEL_PARAM_ATOL, PARALLEL_PARAM_MEAN = 1e-4, 1e-6


def parallel_model(conf, state, dev):
    """The flagship of `conf` (a train_config dict) holding `state` (None:
    as built) on dev."""
    from masr_tpu_torch.data.normalizer import FeatureNormalizer
    from masr_tpu_torch.models.cmvn import GlobalCMVN
    from masr_tpu_torch.models.registry import build_model
    norm = FeatureNormalizer(conf["dataset_conf"]["mean_istd_path"])
    model = build_model("conformer", 80, VOCAB, streaming=True,
                        encoder_conf=conf["encoder_conf"],
                        decoder_conf=conf["decoder_conf"],
                        model_conf=conf["model_conf"],
                        cmvn=GlobalCMVN(norm.mean, norm.istd))
    if state is not None:
        model.load_state_dict(state)
    return model.to(dev)


def sync(dev):
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def parallel_steps(conf, state, batch, dev, grid=None):
    """PARALLEL_STEPS train steps of the flagship from `state` on `batch`
    (this rank's rows under `grid`) → per step (loss, wall s, launches),
    the model, the optimizer, the slices (parallel/tp.py Shards) and the
    first update's grads (the ranks' mean, before the clip; flat, CPU)."""
    from masr_tpu_torch.optimizer.schedulers import build_optimizer
    from masr_tpu_torch.parallel import mesh
    from masr_tpu_torch.parallel.tp import shard_params
    from masr_tpu_torch.training import train_state
    model = mesh.replicate(parallel_model(conf, state, dev), grid)
    shards = shard_params(model, grid or mesh.Grid())
    opt, sched, _ = build_optimizer(shards.opt_params(), PARALLEL_OPT)
    ts = train_state.TrainState(model, opt, sched, grad_clip=5.0,
                                accum_grad=1, grid=grid, shards=shards)
    rows = train_state.batch_to(batch, dev)
    out, grads, apply = [], [], train_state._apply_update

    def recording(st, finite, shards=None):
        if not grads:
            grads.append(torch.cat([a.reshape(-1) for a in st.acc]).cpu())
        return apply(st, finite, shards)

    train_state._apply_update = recording
    try:
        for _ in range(PARALLEL_STEPS):
            reset_train_launches()
            sync(dev)
            t0 = time.perf_counter()
            m = train_state.train_step(ts, rows, 0)
            sync(dev)
            out.append({"loss": m["loss"], "finite": m["finite"],
                        "s": time.perf_counter() - t0,
                        "launches": list(train_launches())})
    finally:
        train_state._apply_update = apply
    return out, model, opt, shards, grads[0]


def param_grad_diffs(model, grads, ref_grads):
    """Per parameter of `model`: (the largest difference of the flat
    `grads` from `ref_grads`, the largest |ref_grads|)."""
    out, i = {}, 0
    for k, p in model.named_parameters():
        g, r = grads[i:i + p.numel()], ref_grads[i:i + p.numel()]
        out[k] = (float((g - r).abs().max()), float(r.abs().max()))
        i += p.numel()
    return out


def parallel_rank(spec_path, out_path):
    """A rank of phase 68 (python3 chip_smoke.py --parallel-rank SPEC OUT):
    joins the gloo group of SPEC's file store on SPEC's device, runs its jobs
    (tensor_parallel 1, then 2) on its rows of the global batch and writes
    per step the loss, wall and launches, the grad all-reduce's seconds,
    the peak device memory, the largest difference of its parameters from
    SPEC's one-process ones and the moments' shapes to OUT."""
    from masr_tpu_torch.parallel import mesh
    from masr_tpu_torch.training import train_state
    spec = torch.load(spec_path, weights_only=False)
    dev = torch.device(spec["device"])
    # f32 products and convolutions, as main() and the trainer set them
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh.maybe_init_distributed(dev, backend="gloo",
                                init_method="file://" + spec["store"])
    reduce_s, orig = [], mesh.all_reduce

    def timed_all_reduce(t, *a, **kw):
        # the flattened grads' all-reduce (the metrics' is 5 floats)
        if t.numel() < 1024:
            return orig(t, *a, **kw)
        sync(dev)
        t0 = time.perf_counter()
        r = orig(t, *a, **kw)
        sync(dev)
        reduce_s.append(time.perf_counter() - t0)
        return r

    train_state.mesh.all_reduce = timed_all_reduce
    results = {}
    for tp in (1, 2):
        grid = mesh.make_mesh_2d(tp)
        rows = mesh.shard_batch(spec["batch"], grid.rank, grid.world)
        del reduce_s[:]
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        steps, model, opt, shards, grads = parallel_steps(
            spec["conf"], spec["state"], rows, dev, grid)
        names = [n for n, _ in model.named_parameters()]
        results[tp] = {
            "steps": steps, "allreduce_s": list(reduce_s),
            "peak_bytes": torch.cuda.max_memory_allocated(dev)
            if dev.type == "cuda" else None,
            "rank": grid.rank, "world": grid.world, "tp": grid.tp,
            "param_diff": {k: (float(d.max()), float(d.mean())) for k, d in (
                (k, (v.detach().cpu() - spec["ref_params"][k]).abs())
                for k, v in model.state_dict().items())},
            "moments": {names[i]: [tuple(opt.state[p][k].shape)
                                   for k in ("exp_avg", "exp_avg_sq")]
                        for i, p in enumerate(shards.opt_params())},
            "ruled": {names[i]: d for i, d in shards.dims.items()},
            "grad_diff": param_grad_diffs(model, grads, spec["ref_grads"])}
        del model, opt, shards
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    torch.distributed.barrier()
    torch.save(results, out_path)
    torch.distributed.destroy_process_group()
    return 0


def parallel_corpus(corpus, root, n):
    """phase 12's corpus cut to its n shortest training utterances (a
    manifest of its own) → corpus dict."""
    os.makedirs(root, exist_ok=True)
    with open(corpus["train"], encoding="utf-8") as f:
        rows = f.readlines()[:n]
    out = dict(corpus, train=os.path.join(root, "manifest.train"))
    with open(out["train"], "w", encoding="utf-8") as f:
        f.writelines(rows)
    return out


def phase_parallel_train(dev, corpus, smi):
    """Phase 68: (a) dp = 2 and (b) dp = 1 x tp = 2, two gloo ranks on the
    card, each 2 steps on 8 rows of a global batch of 16, against one
    process's 2 steps on the 16 from the same weights (dropout 0): loss
    rel 1e-5, the first update's grads, every parameter 1e-4 abs and each
    tensor's mean difference 1e-6 (PARALLEL_OPT's note), 24 row-3 and 2 row-4 launches a
    rank and step, (b)'s ruled Adam moments half their tensor; (c)
    MASRTrainer under a NCCL group of one (WORLD_SIZE=1, RANK=0,
    LOCAL_RANK=0), one epoch of 2 steps: finite losses, the same launches;
    (d) row 4 on an infeasible batch (B=8, T'=299, two rows with more
    labels than frames): kernel against the twin, optax's semantics. →
    ((c)'s row-3 launches, its row-4 launches, (d)'s grad error)."""
    from masr_tpu_torch.data.collate import collate_fn
    from masr_tpu_torch.data.dataset import MASRDataset
    from masr_tpu_torch.parallel import mesh
    from masr_tpu_torch.training import trainer as tr
    t_phase = time.perf_counter()
    root = os.path.join(WORK, "parallel")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    n_rows = 2 * PARALLEL_RANK_ROWS
    small = parallel_corpus(corpus, os.path.join(root, "corpus"), n_rows)
    conf = train_config(small, root, 1, dropout=False)
    conf["optimizer_conf"] = PARALLEL_OPT
    conf["train_conf"] = dict(conf["train_conf"], accum_grad=1,
                              log_interval=1)
    ds = MASRDataset(PREPROCESS, small["train"], small["vocab"], train=False)
    batch = collate_fn([ds[i] for i in range(n_rows)], shuffle=False)
    seed_model = parallel_model_init(conf)
    state = {k: v.detach().cpu() for k, v in seed_model.state_dict().items()}
    del seed_model
    n = FLAGSHIP_ENCODER["num_blocks"]
    want = [2 * n, n, 2, 1]

    # the one process's reference, B=16
    ref, ref_model, _, _, ref_grads = parallel_steps(conf, state, batch, dev)
    ref_params = {k: v.detach().cpu() for k, v in
                  ref_model.state_dict().items()}
    del ref_model
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    for st in ref:
        check(st["finite"] and st["launches"] == want,
              f"parallel reference step launches {st['launches']} == {want}")

    # (a), (b): two ranks over gloo on the card
    spec = os.path.join(root, "spec.pt")
    torch.save({"store": os.path.join(root, "store"), "conf": conf,
                "state": state, "batch": batch, "device": str(dev),
                "ref_params": ref_params, "ref_grads": ref_grads}, spec)
    env = dict(os.environ, WORLD_SIZE="2")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--parallel-rank", spec,
         os.path.join(root, f"rank{r}.pt")],
        env=dict(env, RANK=str(r), LOCAL_RANK="0")) for r in range(2)]
    try:
        for p in procs:
            p.wait(timeout=600)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    check(all(p.returncode == 0 for p in procs),
          f"parallel ranks exit {[p.returncode for p in procs]}")
    ranks = [torch.load(os.path.join(root, f"rank{r}.pt"),
                        weights_only=False) for r in range(2)]
    summary = {}
    for tp, name in ((1, "dp2"), (2, "tp2")):
        diffs, gdiff = {}, {}
        for r in ranks:
            for k, (d, m) in r[tp]["param_diff"].items():
                d0, m0 = diffs.get(k, (0.0, 0.0))
                diffs[k] = (max(d, d0), max(m, m0))
            for k, (d, g) in r[tp]["grad_diff"].items():
                gdiff[k] = (max(d, gdiff.get(k, (0.0,))[0]), g)
        worst_param = max(diffs.items(), key=lambda kv: kv[1][0])
        worst_mean = max(diffs.items(), key=lambda kv: kv[1][1])
        # each tensor's grad difference over its gate
        grad_share = {k: d / (PARALLEL_GRAD_RTOL * g + PARALLEL_GRAD_ATOL)
                      for k, (d, g) in gdiff.items()}
        worst_grad = max(grad_share, key=grad_share.get)
        for r in ranks:
            res = r[tp]
            check((res["world"], res["tp"]) == (2, tp),
                  f"{name}: grid {res['world']} x {res['tp']}")
            for st, st_ref in zip(res["steps"], ref):
                check(st["launches"] == want, f"{name} rank {res['rank']} "
                      f"launches {st['launches']} == {want}")
                check(abs(st["loss"] - st_ref["loss"])
                      <= 1e-5 * abs(st_ref["loss"]),
                      f"{name} loss {st['loss']} vs one process "
                      f"{st_ref['loss']}")
        check(grad_share[worst_grad] <= 1.0, f"{name} first update's grads "
              f"vs one process: {worst_grad} {gdiff[worst_grad]}")
        check(worst_param[1][0] <= PARALLEL_PARAM_ATOL, f"{name} params vs "
              f"one process: {worst_param}")
        check(worst_mean[1][1] <= PARALLEL_PARAM_MEAN, f"{name} params' mean "
              f"difference vs one process: {worst_mean}")
        if tp == 2:
            ruled = ranks[0][2]["ruled"]
            check(len(ruled) >= 6 * n, f"tp2: {len(ruled)} ruled leaves")
            shapes = {k: tuple(v.shape) for k, v in ref_params.items()}
            for r in ranks:
                for k, d in ruled.items():
                    half = list(shapes[k])
                    half[d] //= 2
                    check(r[2]["moments"][k] == [tuple(half)] * 2,
                          f"tp2 rank {r[2]['rank']} moments of {k}")
        summary[name] = {
            "max_param_diff": worst_param,
            "max_param_mean_diff": worst_mean,
            "grad_diff_worst": (worst_grad, gdiff[worst_grad],
                                grad_share[worst_grad]),
            "loss": [st["loss"] for st in ranks[0][tp]["steps"]],
            "loss_one_process": [st["loss"] for st in ref],
            "step_s": [[st["s"] for st in r[tp]["steps"]] for r in ranks],
            "allreduce_s": [r[tp]["allreduce_s"] for r in ranks],
            "peak_bytes": [r[tp]["peak_bytes"] for r in ranks],
            "launches_per_step": want}
    summary["one_process_step_s"] = [st["s"] for st in ref]

    # (c): the trainer over NCCL, a world of one
    nccl_root = os.path.join(root, "nccl")
    nccl_conf = dict(conf, log_dir=os.path.join(nccl_root, "log"))
    nccl_conf["dataset_conf"] = dict(conf["dataset_conf"],
                                     batch_size=PARALLEL_RANK_ROWS)
    keep = {k: os.environ.get(k) for k in ("WORLD_SIZE", "RANK",
                                           "LOCAL_RANK")}
    os.environ.update(WORLD_SIZE="1", RANK="0", LOCAL_RANK="0")
    backend = "nccl" if dev.type == "cuda" else "gloo"
    torch.distributed.init_process_group(
        backend, init_method=f"tcp://127.0.0.1:{free_port()}", rank=0,
        world_size=1)
    try:
        trainer = tr.MASRTrainer(nccl_conf, device=dev)
        check(trainer.grid.distributed and trainer.world == 1
              and torch.distributed.get_backend() == "nccl",
              "the trainer joined the NCCL group")
        summary["nccl"] = {"backend": torch.distributed.get_backend()}
        rows = []
        reset_train_launches()
        with clocked_train_steps(rows):
            trainer.train(save_model_path=os.path.join(nccl_root, "models"),
                          augment_conf_path=None)
        launched = train_launches()
    finally:
        torch.distributed.destroy_process_group()
        for k, v in keep.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    check(len(rows) == PARALLEL_STEPS, f"nccl trainer steps {len(rows)}")
    for r in rows:
        check(r["finite"] and r["launches"] == want,
              f"nccl trainer step launches {r['launches']} == {want}")
    summary["nccl"].update(steps=len(rows), loss=[r["loss"] for r in rows],
                           step_s=[r["s"] for r in rows],
                           launches_per_step=want)

    # (d): row 4 on an infeasible batch
    logits, lens, labels, label_lens = ctc_inputs(dev, seed=68)
    lens[0], lens[1] = 4, 60
    label_lens[1] = 80
    g = torch.Generator().manual_seed(69)
    labels[1] = torch.randint(1, VOCAB - 1, (80,), generator=g).to(dev)
    wts = torch.randn(8, generator=g).to(dev)
    n_k, nll_err, k64, p64 = ctc_card_gates(
        logits, lens, labels, label_lens, wts, "infeasible CTC", dev)
    check(all(1e5 < float(n_k[b]) < 1.01e5 for b in (0, 1))
          and float(n_k[2:].max()) < 1e4,
          f"infeasible CTC NLL {n_k[:3].tolist()}")
    summary["ctc_infeasible"] = {
        "nll": n_k[:2].tolist(), "nll_rel_err": nll_err,
        "grad_err_vs_f64": k64, "twin_grad_err_vs_f64": p64}
    # ... and on a forced alignment past the register chains: 1100 labels
    # from two tokens (S = 2201, the strided kernel) over exactly the
    # frames they need, and over a frame fewer (the card test's
    # test_ctc_kernel_feasibility_edge[S2201] inputs)
    g = torch.Generator().manual_seed(1100)
    flab = torch.randint(1, 3, (1, 1100), generator=g).repeat(2, 1)
    need = 1100 + int((flab[0, 1:] == flab[0, :-1]).sum())
    flog = (2 * torch.randn(2, need + 3, 4, generator=g)).to(dev)
    fw = torch.randn(2, generator=torch.Generator().manual_seed(1100)).to(dev)
    n_f, f_err, f64_err, fp64 = ctc_card_gates(
        flog, torch.tensor([need, need - 1], dtype=torch.int32, device=dev),
        flab.to(dev, torch.int32),
        torch.tensor([1100, 1100], dtype=torch.int32, device=dev), fw,
        "forced-alignment CTC (S = 2201)", dev)
    check(float(n_f[0]) < 5e4 and 1e5 < float(n_f[1]) < 1.1e5,
          f"forced-alignment CTC NLL {n_f.tolist()}")
    summary["ctc_forced_alignment"] = {
        "S": 2201, "frames": [need, need - 1], "nll": n_f.tolist(),
        "nll_rel_err": f_err, "grad_err_vs_f64": f64_err,
        "twin_grad_err_vs_f64": fp64}
    emit({"phase": "parallel_train", "card": smi, **summary,
          "seconds": time.perf_counter() - t_phase})
    return launched[0], launched[2], max(k64, f64_err)


def ctc_card_gates(logits, lens, labels, label_lens, wts, what, dev):
    """Row 4's kernel against its plain twin in f32 and in f64 on one
    batch, the card tests' gates: 1 + 1 launches, NLL rel 1e-5 of the f32
    twin's, grad within max(2 x the f32 twin's error, 1e-4) of the f64
    twin's (a comparison: its launches are not the main path's). → (NLL
    f64, NLL rel err, grad err vs f64, the f32 twin's grad err vs f64)."""
    from masr_tpu_torch.ops.cuda import ctc_loss as C
    out = {}
    for name, fn, dt in (("kernel", C.ctc_loss, torch.float32),
                         ("plain", C.ctc_loss_plain, torch.float32),
                         ("f64", C.ctc_loss_plain, torch.float64)):
        lg = logits.detach().to(dt).clone().requires_grad_(True)
        before = C.ctc_loss.launches
        nll = fn(lg, lens, labels, label_lens)
        (nll * wts.to(dt)).sum().backward()
        sync(dev)
        out[name] = (nll.detach().double(), lg.grad.double(),
                     C.ctc_loss.launches - before)
    (n_k, g_k, launched_k), (n_p, g_p, _), (n_64, g_64, _) = (
        out["kernel"], out["plain"], out["f64"])
    check(launched_k == 2, f"{what} launches {launched_k} == 2")
    nll_err = float(((n_k - n_p).abs() / n_p.abs()).max())
    check(nll_err <= 1e-5, f"{what} NLL kernel vs twin {nll_err}")
    k64 = float((g_k - g_64).abs().max())
    p64 = float((g_p - g_64).abs().max())
    check(k64 <= max(2 * p64, 1e-4), f"{what} grad {k64} vs twin {p64}")
    return n_k, nll_err, k64, p64


def parallel_model_init(conf):
    """The flagship of `conf` on the CPU with flax_like_init's weights of
    seed 68."""
    from masr_tpu_torch.models.weights import flax_like_init
    model = parallel_model(conf, None, "cpu")
    flax_like_init(model, torch.Generator().manual_seed(68))
    return model


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
    # the native beam search library (g++) builds beside the kernels
    gxx = {}

    def build_native():
        from masr_tpu_torch.decoders import native
        native.build()
        gxx["seconds"] = time.perf_counter() - t0

    native_build = threading.Thread(target=build_native)
    native_build.start()
    built = build.build(["conformer_layer", "chunk_layer",
                         "squeezeformer_layer", "chunk_layer_sq",
                         "conformer_layer_train", "ctc_loss",
                         "squeezeformer_layer_train", "rel_pos_attention"])
    native_build.join()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_seconds": built, "gxx_seconds": gxx.get("seconds"),
          "card": smi})

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
    sq_launches_t, sq_rows, sq_trainer, sq_bn_rows = phase_sq_train(
        dev, corpus)
    sq_train_t = phase_sq_train_times(dev, sq_rows, sq_trainer, smi)

    flash_worst = phase_flash_kernels(dev)
    static_runs, static_launches = {}, {}
    for family in ("conformer", "squeezeformer"):
        s_gpu, long, static_launches[family] = phase_static_flagship(
            dev, family)
        static_runs[family] = (s_gpu, long)
    flash_t = phase_flash_times(dev, smi, static_runs)

    phase_decoders_bundle(dev)
    flag = phase_decoders_flagship(dev, wavs, smi)
    stream_times = phase_decoders_stream(dev, flag, path, wavs)
    phase_decoders_eval(dev, corpus)
    phase_decoder_times(dev, flag, wavs, stream_times, smi)

    exported = phase_export(dev, corpus, wavs)
    phase_eval_cli(dev, exported)
    rec = phase_long_audio(dev)
    phase_server(dev, exported, rec, path, wavs)

    phase_eff_kernels(dev, smi)
    eff_gpu, _, _ = phase_eff_flagship(dev)
    phase_eff_stream(dev, eff_gpu, wavs, smi)
    eff_trainer, eff_conf, eff_rows = phase_eff_train(dev, corpus, smi)
    phase_eff_export(dev, eff_trainer, eff_conf, wavs)

    ds2_gpu, ds2_wavs, _ = phase_ds2_flagship(dev, smi)
    phase_ds2_stream(dev, ds2_gpu, ds2_wavs, smi)
    ds2_rows = phase_ds2_train(dev, corpus, ds2_wavs, smi)
    half = phase_train_aug(dev, corpus, rows, trainer, smi)
    phase_train_device_frontend(dev, half, smi)

    bf16 = phase_bf16_kernels(dev, smi)
    bf16_layer_launches = phase_bf16_offline(dev, gpu, wavs)
    (bf16_chunk_launches, product_launched), _, _ = phase_bf16_stream(
        dev, path, wavs, smi)
    bf16_flash_launches = phase_bf16_static(
        dev, static_runs["conformer"][0], wavs, static_runs["conformer"][1])

    bf16_sq = phase_bf16_sq_kernels(dev, smi)
    n, tail = FLAGSHIP_ENCODER["num_blocks"], EFF_TAIL
    (_, sq_layer_bf16, *_), (_, sq_chunk_bf16, _) = phase_bf16_family(
        dev, "squeezeformer", sq_gpu.model_dir, sq_path, wavs, smi,
        (n, n, 0, 0, SQ_PRODUCTS), (0, 0, n, n, SQ_PRODUCTS))
    phase_bf16_family(dev, "efficient_conformer", eff_gpu.model_dir,
                      write_stream_bundle(eff_gpu.model_dir), wavs, smi,
                      (tail, tail, 0, 0, EFF_PRODUCTS[0]),
                      (0, 0, 0, 0, EFF_PRODUCTS[1]))
    # DS2's one product: its CTC head
    phase_bf16_family(dev, "deepspeech2",
                      os.path.join(WORK, "ds2_lstm_bidirect_bundle"),
                      write_stream_bundle(ds2_gpu.model_dir), ds2_wavs, smi,
                      (0, 0, 0, 0, 1), (0, 0, 0, 0, 1))

    train_bf16 = phase_train_kernels_bf16(dev, smi)
    conf_sample = ["encoder.embed.out.0.weight",
                   "encoder.encoders.0.feed_forward.w_1.weight",
                   "encoder.encoders.6.self_attn.linear_q.weight",
                   "encoder.encoders.11.conv_module.depthwise_conv.weight",
                   "encoder.encoders.11.norm_final.weight",
                   "ctc.ctc_lo.weight"]
    row3_bf16 = phase_train_bf16(dev, "train_bf16", "conformer", corpus,
                                 rows, smi, train_config, conf_sample)
    sq_sample = ["encoder.embed.input_proj.0.weight",
                 "encoder.encoders.0.self_attn.ada_scale",
                 "encoder.encoders.0.ffn1.w_1.weight",
                 "encoder.encoders.6.conv_module.ada_bias",
                 "encoder.time_recover_layer.weight",
                 "encoder.encoders.11.layer_norm4.weight",
                 "ctc.ctc_lo.weight"]
    row7_bf16 = phase_train_bf16(dev, "sq_train_bf16", "squeezeformer",
                                 corpus, sq_rows, smi, sq_train_config,
                                 sq_sample, no_positional_dropout)

    eff_tail_bf16 = phase_eff_train_kernels_bf16(dev, smi)
    train_bf16["row3"]["max_abs_err"] = max(
        train_bf16["row3"]["max_abs_err"], eff_tail_bf16["max_abs_err"])
    phase_train_bf16(dev, "sq_bn_train_bf16", "squeezeformer", corpus,
                     sq_bn_rows, smi, sq_bn_train_config, sq_sample,
                     no_positional_dropout, n=0, draws=3)
    eff_row3_bf16 = phase_train_bf16(
        dev, "eff_train_bf16", "efficient_conformer", corpus, eff_rows, smi,
        eff_train_config, EFF_BF16_SAMPLE, n=EFF_TAIL)
    phase_train_bf16(dev, "ds2_train_bf16", "deepspeech2", corpus, ds2_rows,
                     smi, ds2_amp_config, DS2_BF16_SAMPLE, n=0)
    phase_pipeline(dev, corpus, smi)

    converted = phase_convert_checkpoint(dev, corpus, wavs)
    phase_avg_checkpoints(dev, corpus, wavs)
    phase_tune(dev, corpus, converted)
    phase_soak_stream(dev, path)
    phase_gui_stream(dev, path, corpus)

    slice16 = phase_subsampling_kernels(dev, wavs, smi)
    eager_flash = phase_eager_routes(dev, wavs, smi)
    phase_small_gaps(dev, corpus, wavs, smi)
    p_row3, p_row4, p_ctc_err = phase_parallel_train(dev, corpus, smi)

    emit({"phase": "total", "seconds": time.perf_counter() - t_start})
    emit({"kernels": [{
        "name": "fused_conformer_layer", "route": "cuda",
        "source": "masr_tpu_torch/csrc/conformer_layer.cu",
        "replaces": "masr_tpu/ops/pallas/conformer_layer.py:188",
        "launches": launches + slice16["row1"],
        "max_abs_err": max(worst, err), "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound["bound_ms"],
        "bound_by": bound["bound_by"], "library_ms": None}, {
        "name": "fused_chunk_layer", "route": "cuda",
        "source": "masr_tpu_torch/csrc/chunk_layer.cu",
        "replaces": "masr_tpu/ops/pallas/chunk_layer.py:412",
        "launches": chunk_launches_main + slice16["row2"],
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
        "launches": t_launches[0] + slice16["row3"] + p_row3,
        "max_abs_err": train_err,
        "ms": t_layer["ms"], "plain_ms": t_layer["plain_ms"],
        "bound_ms": t_layer["bound_ms"], "bound_by": t_layer["bound_by"],
        "library_ms": None}, {
        "name": "ctc_loss", "route": "cuda",
        "source": "masr_tpu_torch/csrc/ctc_loss.cu",
        "replaces": "masr_tpu/ops/pallas/ctc_loss.py:158",
        "launches": t_launches[2] + slice16["row4"] + p_row4,
        "max_abs_err": max(ctc_err, p_ctc_err),
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
        "launches": static_launches["conformer"] + eager_flash,
        "max_abs_err": max(flash_worst, flash_t["max_abs_err"]),
        "ms": flash_t["ms"], "plain_ms": flash_t["plain_ms"],
        "bound_ms": flash_t["bound_ms"], "bound_by": flash_t["bound_by"],
        "library_ms": flash_t["library_ms"]}] + [{
        "name": name + " (bf16 mode)", "route": "cuda",
        "source": f"masr_tpu_torch/csrc/{src}.cu", "replaces": replaces,
        "launches": launched, "max_abs_err": bf16[row]["max_abs_err"],
        "ms": bf16[row]["ms"], "plain_ms": bf16[row]["plain_ms"],
        "bound_ms": bf16[row]["bound_ms"],
        "bound_by": bf16[row]["bound_by"],
        "library_ms": bf16[row]["library_ms"]}
        for name, src, replaces, row, launched in (
            ("fused_conformer_layer", "conformer_layer",
             "masr_tpu/ops/pallas/conformer_layer.py:188", "row1",
             bf16_layer_launches),
            ("fused_chunk_layer", "chunk_layer",
             "masr_tpu/ops/pallas/chunk_layer.py:412", "row2",
             bf16_chunk_launches),
            ("rel_pos_flash_attention", "rel_pos_attention",
             "masr_tpu/ops/pallas/attention.py:122", "row5",
             bf16_flash_launches))] + [{
        "name": name + " (bf16 mode)", "route": "cuda",
        "source": f"masr_tpu_torch/csrc/{src}.cu", "replaces": replaces,
        "launches": launched, **{
            k: bf16_sq[row][k] for k in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms")}}
        for name, src, replaces, row, launched in (
            ("fused_squeezeformer_layer", "squeezeformer_layer",
             "masr_tpu/ops/pallas/squeezeformer_layer.py:166", "row6",
             sq_layer_bf16),
            ("fused_chunk_layer_sq", "chunk_layer_sq",
             "masr_tpu/ops/pallas/chunk_layer_sq.py:181", "row8",
             sq_chunk_bf16))] + [{
        # no Pallas kernel: the XLA dot of flax's Dense (every bf16 Linear
        # and pointwise conv, models/layers.py), made a kernel of the port
        # so that a window's bits do not depend on the engine's batch
        "name": "serving_product (bf16 mode)", "route": "cuda",
        "source": "masr_tpu_torch/csrc/chunk_layer.cu",
        "replaces": "masr_tpu/models/subsampling.py:69",
        "launches": product_launched, **{
            k: bf16["product"][k] for k in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms")}}] + [{
        "name": name + " (bf16 mode)", "route": "cuda",
        "source": f"masr_tpu_torch/csrc/{name[6:]}.cu", "replaces": replaces,
        "launches": launched, **{
            k: train_bf16[row][k] for k in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms")}}
        for name, replaces, row, launched in (
            # the flagship's and the Efficient-Conformer's bf16 runs
            ("fused_conformer_layer_train",
             "masr_tpu/ops/pallas/conformer_layer_train.py:674", "row3",
             row3_bf16 + eff_row3_bf16),
            ("fused_squeezeformer_layer_train",
             "masr_tpu/ops/pallas/squeezeformer_layer_train.py:608", "row7",
             row7_bf16))]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--parallel-rank"]:
        sys.exit(parallel_rank(sys.argv[2], sys.argv[3]))
    sys.exit(main())
