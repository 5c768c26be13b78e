"""Digest and time the port's kernels on the card, to compare two trees.

    python3 -m masr_tpu_torch.bench.kernel_digest [--ctc-only | --flash |
                                                   --train-bf16]

Runs the three Conformer layer kernels of the package importable from the
working directory on fixed seeded inputs at the flagship width (D=256, 4
heads, FFN 2048, conv 15):
  - fused_conformer_layer at B=8, T'=299, lens 299..33, and at B=1 on
    utterance 2's inputs;
  - fused_chunk_layer at B=32, c=16, C=256, table positions, cache_len
    {0, 5, 100, 256}, four inactive slots, and at B=1 on slot 7's inputs
    (a full cache: predict_stream's shape);
  - fused_conformer_layer_train, forward and backward, at B=8, T'=299 with
    a dynamic-chunk mask and dropout 0.1;
and, in a tree that has them, fused_squeezeformer_layer (the
Squeezeformer's width: conv 31; BatchNorm and layer_norm conv, each at
T'=299 and at the half rate's T'=150 with the lens halved, rounding up;
B=8 and B=1) and
fused_squeezeformer_layer_train (layer_norm conv) on the same inputs,
fused_chunk_layer_sq at B=32 and at B=1 (slot 7) at full rate (c=16,
C=256) and half rate (c=8, C=128 on the full-resolution ring), and
rel_pos_flash_attention (4 heads, d_k 64) at B=8, T'=1500 under a static
chunk of 16 with lens 1500..800 and 0 (rows that see no key); and
ctc_loss at chip_smoke's CTC shape (B=8, T'=299, V=4000, S=161; `ctc_row`:
the forward and the backward timed apart, each with its kernels' device
times, F.ctc_loss as a yardstick, the SM clock; `--ctc-only` runs that
row alone); `--flash` runs `flash_rows` alone (row 5 in f32 and bf16
across T' 150..3000 beside SDPA bf16, rows 1 and 6 in bf16 and f32);
`--train-bf16` runs `train_bf16_rows` alone (rows 3 and 7 in their bf16
modes at chip_smoke phase 52's shapes, beside their f32 route).
It prints one JSON line: a sha256 digest of each kernel's output bytes
(outputs, updated caches, grads), each kernel's CUDA-event time over 20
calls, the card's name and power limit, for every kernel but CTC the
device time per call of each CUDA kernel it launches (torch.profiler:
`kernels` by name, and for the serving layers `launch_split`, each launch
of one call in launch order, so that products of different shapes stand
apart), whether each serving layer's B=1 call gave the bits of its slice
of the batched call (`batch_invariant`), the host time to enqueue one
serving-layer call (`host_ms`), and, as a yardstick only, the device time
of a torch.matmul in f32 of each product shape of the serving layers
(`matmul`; the kernels never call it). Two trees whose digests are equal
computed the same bits; run both on one card, one after the other in the
order A, B, B, A, to compare their times. Uses only entry points that every tree since
the training slice has (and a layer's chunk_packed_params where the tree
has it), so it can be copied into an older tree.
"""
import hashlib
import json
import re
import subprocess
import sys
import time

import torch


def _digest(tensors):
    """sha256 of the tensors' bytes (None, a grad that was not formed,
    hashes as a marker; bf16 as its 16-bit words)."""
    h = hashlib.sha256()
    for t in tensors:
        if t is None:
            h.update(b"none")
            continue
        t = t.detach().contiguous().cpu()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        h.update(t.numpy().tobytes())
    return h.hexdigest()[:16]


def _ms(fn, iters=20):
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


def _host_ms(fn, iters=20):
    """Host time per call (ms) to enqueue fn's work: perf_counter over
    iters back-to-back calls after a synchronize, before the next one."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e3 / iters


def _kernels(fn, n=3):
    """Device time per call (ms) of each CUDA kernel that fn launches,
    torch.profiler over n calls, largest first."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0.0)
        if us > 0:
            out[ev.key[:110]] = us / 1e3 / n
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def _short(name):
    """A CUDA kernel's name without its namespace and parameter list."""
    name = name.replace("(anonymous namespace)::", "")
    name = re.sub(r"^void ", "", name)
    depth = 0
    for i, ch in enumerate(name):
        depth += ch == "<"
        depth -= ch == ">"
        if ch == "(" and depth == 0 and i > 0:
            return name[:i]
    return name


def _launch_split(fn, n=3):
    """Device time (ms) of each CUDA kernel, memset and copy that one call
    of fn launches, in launch order ("NN name"), averaged over n calls
    (torch.profiler), and their "total". Where the calls' device events do
    not line up, the time per call of each name instead, and the number of
    events under "unaligned_events"."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    evs = sorted((e for e in prof.events()
                  if getattr(e, "device_type", None) == DeviceType.CUDA),
                 key=lambda e: e.time_range.start)
    per = len(evs) // n
    aligned = bool(evs) and len(evs) % n == 0 and all(
        len({_short(evs[i + j * per].name) for j in range(n)}) == 1
        for i in range(per))
    out = {}
    for i, e in enumerate(evs):
        key = f"{i % per:02d} {_short(e.name)}" if aligned else _short(e.name)
        out[key] = out.get(key, 0.0) + e.time_range.elapsed_us() / n / 1e3
    out["total"] = sum(out.values())
    if not aligned:
        out["unaligned_events"] = len(evs)
    return out


def _same_bits(got, want):
    return all(torch.equal(a, b) for a, b in zip(got, want))


def _chunk_products(B, c, D, F, ksize):
    """(M, N, K) of a chunk-layer call's products at B slots (q/k/v as one
    product of N = 3D), and how many times the call runs each."""
    M = B * c
    return {"ffn_w1": ((M, F, D), 2), "ffn_w2": ((M, D, F), 2),
            "qkv": ((M, 3 * D, D), 1), "out_pw2": ((M, D, D), 2),
            "pw1": ((B * (ksize - 1 + c), 2 * D, D), 1)}


def _full_products(M, D, F):
    """(M, N, K) of a full-context layer call's products over M = B·T'
    rows (q/k/v as one product), and how many times the call runs each."""
    return {"ffn_w1": ((M, F, D), 2), "ffn_w2": ((M, D, F), 2),
            "qkv": ((M, 3 * D, D), 1), "out_pw2": ((M, D, D), 2),
            "pw1": ((M, 2 * D, D), 1)}


def _matmul(products, dev):
    """Yardstick: device ms (torch.profiler) of torch.matmul in f32 (no
    TF32) of each product shape, and their sum over one layer call."""
    g = torch.Generator().manual_seed(12)
    out, total = {}, 0.0
    for name, ((M, N, K), times) in products.items():
        a = torch.randn(M, K, generator=g).to(dev)
        b = torch.randn(K, N, generator=g).to(dev)
        out[f"{name} {M}x{N}x{K}"] = t = sum(
            _kernels(lambda: a @ b, n=10).values())
        total += times * t
    out["layer"] = total
    return out


def _smi():
    """The card's name, SM clock (MHz), power draw and power limit (W),
    one nvidia-smi reading."""
    return subprocess.run(
        ["nvidia-smi",
         "--query-gpu=name,clocks.sm,power.draw,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def ctc_row(dev):
    """Row 4 through the `ctc_loss` entry that every tree since the
    training slice has, at chip_smoke's CTC shape (B=8, T'=299, V=4000,
    label lengths 5..80, S=161): digests of the NLL and of the logits grad
    of a weighted sum; CUDA-event times of the forward (grad recorded),
    the backward (torch.autograd.grad, so nothing accumulates), both, and
    the forward without grad (the eval passes); each CUDA kernel's device
    time per call for the forward and the backward apart; F.ctc_loss on
    log_softmax, forward + backward, as a yardstick only; chip_smoke's own
    way of timing it (a copy of the logits, forward, .sum().backward());
    nvidia-smi's SM clock and power before and after."""
    import torch.nn.functional as F
    from masr_tpu_torch.ops.cuda import build
    from masr_tpu_torch.ops.cuda import ctc_loss as C
    build.build(["ctc_loss"])
    g = torch.Generator().manual_seed(6)
    T, V = 299, 4000
    label_lens = torch.tensor([5, 10, 15, 20, 25, 30, 40, 80],
                              dtype=torch.int32)
    lens = torch.tensor([33, 90, 150, 180, 220, 250, 281, T],
                        dtype=torch.int32)
    B = len(label_lens)
    x = (2 * torch.randn(B, T, V, generator=g)).to(dev).requires_grad_(True)
    labels = torch.randint(1, V - 1, (B, 80), generator=g)
    labels[torch.arange(80)[None] >= label_lens[:, None]] = -1
    labels, lens, label_lens = (labels.to(dev, torch.int32), lens.to(dev),
                                label_lens.to(dev))
    w = torch.randn(B, generator=g).to(dev)

    def fwd():
        return C.ctc_loss(x, lens, labels, label_lens)

    nll = fwd()
    (grad,) = torch.autograd.grad(nll, x, w, retain_graph=True)

    def bwd():
        return torch.autograd.grad(nll, x, w, retain_graph=True)

    def both():
        return torch.autograd.grad(fwd(), x, w)

    def fwd_nograd():
        with torch.no_grad():
            return fwd()

    targets, lp_lens, tl = labels.clamp(min=0).long(), lens.long(), \
        label_lens.long()

    def smoke_style():
        # as chip_smoke's train_times times it: a copy of the logits, the
        # forward, and .sum().backward() into a fresh leaf's .grad
        xc = x.detach().clone().requires_grad_(True)
        C.ctc_loss(xc, lens, labels, label_lens).sum().backward()

    def library():
        loss = F.ctc_loss(torch.log_softmax(x, -1).transpose(0, 1), targets,
                          lp_lens, tl, reduction="none")
        return torch.autograd.grad(loss, x, w)

    smi_before = _smi()
    out = {"digest": _digest([nll, grad]), "fwd_ms": _ms(fwd),
           "bwd_ms": _ms(bwd), "fwd_bwd_ms": _ms(both),
           "fwd_nograd_ms": _ms(fwd_nograd),
           "smoke_style_ms": _ms(smoke_style),
           "kernels_smoke_style": _kernels(smoke_style),
           "library_fwd_bwd_ms": _ms(library),
           "kernels_fwd": _kernels(fwd), "kernels_bwd": _kernels(bwd),
           "kernels_fwd_nograd": _kernels(fwd_nograd)}
    out["smi"] = [smi_before, _smi()]
    out["nll"] = nll.detach().double().tolist()
    return out


def train_products(B, T, D, F, H):
    """(batch, M, N, K) of each product of one training layer's forward and
    backward (rows 3 and 7 run the same ones: two FFNs, the attention, the
    conv module) and how many times a fwd + bwd runs it."""
    M, dk = B * T, D // H
    return {"ffn_w1": ((1, M, F, D), 2), "ffn_w2": ((1, M, D, F), 2),
            "ffn_dz": ((1, M, F, D), 2), "ffn_da": ((1, M, D, F), 2),
            "ffn_dw1": ((1, D, F, M), 2), "ffn_dw2": ((1, F, D, M), 2),
            "att_qkvo_dO_da": ((1, M, D, D), 9),
            "att_dw": ((1, D, D, M), 4),
            "att_scores_dP": ((B * H, T, T, dk), 3),
            "att_pv_dv_dq_dk": ((B * H, T, dk, T), 6),
            "att_dposp": ((H, T, dk, M), 1),
            "conv_pw1": ((1, M, 2 * D, D), 1), "conv_pw2": ((1, M, D, D), 2),
            "conv_dpw1": ((1, D, 2 * D, M), 1),
            "conv_dpw2": ((1, D, D, M), 1), "conv_da": ((1, M, D, 2 * D), 1)}


def _matmul_bf16(products, dev):
    """Yardstick: device ms (torch.profiler) of torch.matmul in bf16 of
    each product shape, and their sum over one fwd + bwd."""
    g = torch.Generator().manual_seed(14)
    out, total = {}, 0.0
    for name, ((n, M, N, K), times) in products.items():
        a = torch.randn(n, M, K, generator=g).to(dev, torch.bfloat16)
        b = torch.randn(n, K, N, generator=g).to(dev, torch.bfloat16)
        out[f"{name} {n}x{M}x{N}x{K}"] = t = sum(
            _kernels(lambda: a @ b, n=10).values())
        total += times * t
    out["layer"] = total
    return out


def _entry_host_ms(module, names, fn, n=10):
    """Host ms per call of each named C entry of module's library while fn
    runs (each call timed around the ctypes call, after a synchronize, so
    the launch queue is empty), median over n runs of fn."""
    lib = module._lib()
    real = {nm: getattr(lib, nm) for nm in names}
    spent = {nm: [] for nm in names}

    def timed(nm):
        def call(*args):
            t0 = time.perf_counter()
            r = real[nm](*args)
            spent[nm].append((time.perf_counter() - t0) * 1e3)
            return r
        return call

    for nm in names:
        setattr(lib, nm, timed(nm))
    try:
        for _ in range(n):
            fn()
            torch.cuda.synchronize()
    finally:
        for nm in names:
            setattr(lib, nm, real[nm])
    return {nm: sorted(v)[len(v) // 2] if v else None
            for nm, v in spent.items()}


def _split_products(kernels):
    """A kernel dict's device ms: the products (the bf16 mode's
    tw_gemm_kernel and tw_sum_kernel, the f32 route's gemm_tc_kernel and
    splitk_sum_kernel) apart from the rest."""
    prod = sum(v for k, v in kernels.items()
               if "gemm_kernel" in k or "gemm_tc_kernel" in k
               or "splitk_sum" in k or "tw_sum" in k)
    return {"products_ms": prod, "rest_ms": sum(kernels.values()) - prod,
            "total_ms": sum(kernels.values())}


def train_bf16_rows(dev):
    """Rows 3 and 7 in their bf16 modes at chip_smoke phase 52's shapes
    (B=8, lens 299..33, a dynamic-chunk mask, dropout 0.1 / 0.1; row 7 also
    at the half rate's T'=150): digests of the output and every grad; the
    forward and the backward by CUDA events, and the f32 route's at the
    same shape; each CUDA kernel's device time of one forward + backward
    (the products apart from the rest); the C entries' host time; the
    launches of one call; the layer's product shapes as torch.matmul bf16
    (a yardstick only); row 3's launches one by one in launch order."""
    import torch.nn.functional as F
    from masr_tpu_torch.models.conformer import ConformerEncoderLayer
    from masr_tpu_torch.models.embedding import sinusoid_position_encoding
    from masr_tpu_torch.models.squeezeformer import SqueezeformerEncoderLayer
    from masr_tpu_torch.models.weights import seeded_state_dict
    from masr_tpu_torch.ops.cuda import build
    from masr_tpu_torch.ops.cuda import conformer_layer_train as clt
    from masr_tpu_torch.ops.cuda import squeezeformer_layer_train as sqt
    build.build(["conformer_layer_train", "squeezeformer_layer_train"])
    bf = torch.bfloat16
    lens_full = [299, 281, 250, 220, 180, 150, 90, 33]
    out = {}
    for row, module, make, ksize in (
            ("row3", clt, lambda: ConformerEncoderLayer(
                256, 4, 2048, cnn_module_kernel=15, causal=True), 15),
            ("row7", sqt, lambda: SqueezeformerEncoderLayer(
                256, 4, 2048, 31, "layer_norm", True), 31)):
        layer = make()
        layer.load_state_dict(seeded_state_dict(layer, seed=21))
        layer = layer.to(dev)
        fn = (clt.fused_conformer_layer_train if row == "row3"
              else sqt.fused_squeezeformer_layer_train)
        entry = ("masr_conformer_layer_train" if row == "row3"
                 else "masr_sq_layer_train")
        for half in ((False, True) if row == "row7" else (False,)):
            g = torch.Generator().manual_seed(22)
            T, B = 299, len(lens_full)
            lens = torch.tensor(lens_full, dtype=torch.int32, device=dev)
            r = torch.arange(T, device=dev)
            rc, cc = r[:, None] // 16, r[None, :] // 16
            mask = ((cc <= rc) & (cc >= rc - 4))[None] & \
                (r[None, None, :] < lens[:, None, None])
            if half:
                mask, lens, r = mask[:, ::2, ::2], (lens + 1) // 2, r[::2]
            Tr = len(r)
            x32 = torch.randn(B, Tr, 256, generator=g).to(dev)
            w = torch.randn(B, Tr, 256, generator=g).to(dev)
            seeds = torch.randint(-2 ** 31, 2 ** 31 - 1, (B,), generator=g,
                                  dtype=torch.int32).to(dev)
            with torch.no_grad():
                pos = sinusoid_position_encoding(r, 256)
                posp = {torch.float32: layer.self_attn.linear_pos(pos),
                        bf: F.linear(pos.to(bf), layer.self_attn.linear_pos
                                     .weight.to(bf))}
                packs = {torch.float32: layer.packed_params(),
                         bf: layer.packed_params(bf)}
            res = {}
            for dt in (bf, torch.float32):
                leaves = {"x": x32.to(dt).requires_grad_(True),
                          "posp": posp[dt].clone().requires_grad_(True),
                          **{k: v.detach().clone().requires_grad_(True)
                             for k, v in packs[dt].items()}}
                wd = w.to(dt)

                def fwd(leaves=leaves):
                    return fn(leaves["x"], mask, seeds, lens,
                              leaves["posp"],
                              {k: leaves[k] for k in packs[dt]}, layer=5,
                              n_head=4, ksize=ksize, causal=True, rate=0.1,
                              att_rate=0.1)

                y = fwd()
                y.backward(wd, retain_graph=True)
                key = "bf16" if dt == bf else "f32"
                res[key + "_fwd_ms"] = _ms(fwd)
                res[key + "_bwd_ms"] = _ms(
                    lambda y=y, wd=wd: y.backward(wd, retain_graph=True))
                res[key + "_ms"] = res[key + "_fwd_ms"] + res[key + "_bwd_ms"]
                if dt != bf:
                    continue
                for v in leaves.values():
                    v.grad = None
                y = fwd()
                y.backward(wd)
                res["digest"] = _digest(
                    [y] + [leaves[k].grad for k in sorted(leaves)])
                kern = _kernels(lambda fwd=fwd, wd=wd: fwd().backward(wd))
                res["kernels"] = kern
                res["split"] = _split_products(kern)
                res["host_ms"] = _entry_host_ms(
                    module, [entry + "_forward_bf16",
                             entry + "_backward_bf16"],
                    lambda fwd=fwd, wd=wd: fwd().backward(wd))
                res["launches"] = _launch_count(
                    lambda fwd=fwd, wd=wd: fwd().backward(wd))
                if row == "row3":
                    res["launch_split"] = _launch_split(
                        lambda fwd=fwd, wd=wd: fwd().backward(wd))
                lib = module._lib()
                nb = getattr(lib, entry + "_saved_floats")
                res["saved_bytes"] = 4 * nb(B, Tr, 256, 2048, 4, 1)
                res["scratch_bytes"] = 4 * getattr(
                    lib, entry + "_scratch_floats")(B, Tr, 256, 2048, 4, 1)
            res["matmul_bf16"] = _matmul_bf16(
                train_products(B, Tr, 256, 2048, 4), dev)
            out[f"{row}_T{Tr}"] = res
    return out


def _launch_count(fn, n=3):
    """CUDA kernels (and copies) one call of fn launches (torch.profiler,
    device events over n calls)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events()
               if getattr(e, "device_type", None) == DeviceType.CUDA) / n


def flash_rows(dev):
    """The attention routes for an A/B of two trees. Row 5 (4 heads, d_k
    64, B=8, lens T'..0.533 T' as chip_smoke's phase 44, the static-16
    mask; q, k, v (B, T', D) rows viewed as heads, p an (H, T', d_k) view)
    at T' 150, 299, 800, 1500 and 3000: digests of the f32 and the bf16
    output, CUDA-event times of both and of SDPA bf16 on the same
    [q+u | q+v], [k | p], v and mask (a yardstick only), each CUDA kernel's
    device time of the bf16 call, and the bf16 output's largest error from
    its bf16 twin in bf16 roundings (2^-8) of the largest output. Rows 1
    and 6 (flagship widths, B=8, T'=299, lens 299..33) in f32 and bf16
    (bf16 x, positions and products): digests and times."""
    import torch.nn.functional as F
    from masr_tpu_torch.models.conformer import ConformerEncoderLayer
    from masr_tpu_torch.models.embedding import sinusoid_position_encoding
    from masr_tpu_torch.models.squeezeformer import SqueezeformerEncoderLayer
    from masr_tpu_torch.models.weights import seeded_state_dict
    from masr_tpu_torch.ops.cuda import build
    from masr_tpu_torch.ops.cuda import conformer_layer as cl
    from masr_tpu_torch.ops.cuda import rel_pos_attention as rpa
    from masr_tpu_torch.ops.cuda import squeezeformer_layer as sql
    from masr_tpu_torch.ops.masks import add_optional_chunk_mask
    build.build(["rel_pos_attention", "conformer_layer",
                 "squeezeformer_layer"])
    bf = torch.bfloat16
    B, H, d = 8, 4, 64
    digests, ms, kernels, err = {}, {}, {}, {}
    for T in (150, 299, 800, 1500, 3000):
        g = torch.Generator().manual_seed(T)
        lens = torch.linspace(T, round(0.533 * T), B).round().long().to(dev)
        pad = torch.arange(T, device=dev)[None, :] < lens[:, None]
        mask = add_optional_chunk_mask(T, pad[:, None, :], False, False, -1,
                                       16, -1)
        q, k, v = (torch.randn(B, T, H * d, generator=g).to(dev).view(
            B, T, H, d).transpose(1, 2) for _ in range(3))
        p = torch.randn(T, H * d, generator=g).to(dev).view(
            T, H, d).transpose(0, 1)
        bu, bv = ((0.1 * torch.randn(H, d, generator=g)).to(dev)
                  for _ in range(2))
        a32 = (q, k, v, p, bu, bv)
        a16 = tuple(t.to(bf) for t in a32)
        q16, k16, v16, p16, bu16, bv16 = a16
        q_cat = torch.cat([q16 + bu16[None, :, None],
                           q16 + bv16[None, :, None]], dim=-1)
        k_cat = torch.cat([k16, p16[None].expand(B, -1, -1, -1)], dim=-1)

        def f32(a32=a32, mask=mask):
            return rpa.rel_pos_flash_attention(*a32, mask)

        def b16(a16=a16, mask=mask):
            return rpa.rel_pos_flash_attention(*a16, mask)

        def sdpa(q_cat=q_cat, k_cat=k_cat, v16=v16, mask=mask):
            return F.scaled_dot_product_attention(
                q_cat, k_cat, v16, attn_mask=mask[:, None],
                scale=1.0 / d ** 0.5)

        with torch.no_grad():
            got = b16()
            want = rpa.rel_pos_attention_plain(*a16, mask)
            top = max(1.0, want.float().abs().max().item())
            err[f"T{T}"] = ((got.float() - want.float()).abs().max().item()
                            / (2 ** -8 * top))
            digests[f"row5_f32_T{T}"] = _digest([f32()])
            digests[f"row5_bf16_T{T}"] = _digest([got])
            ms[f"row5_f32_T{T}"] = _ms(f32)
            ms[f"row5_bf16_T{T}"] = _ms(b16)
            ms[f"sdpa_bf16_T{T}"] = _ms(sdpa)
            kernels[f"row5_bf16_T{T}"] = _kernels(b16)
    T = 299
    g = torch.Generator().manual_seed(12)
    lens = torch.tensor([299, 281, 250, 220, 180, 150, 90, 33],
                        dtype=torch.int32, device=dev)
    x = torch.randn(B, T, 256, generator=g).to(dev)
    r = torch.arange(T, device=dev)
    conf = ConformerEncoderLayer(256, 4, 2048, cnn_module_kernel=15,
                                 causal=True)
    conf.load_state_dict(seeded_state_dict(conf, seed=7))
    sq = SqueezeformerEncoderLayer(256, 4, 2048, 31, "batch_norm", True)
    sq.load_state_dict(seeded_state_dict(sq, seed=10))
    for name, lyr, fn, extra in (
            ("row1", conf, cl.fused_conformer_layer, {}),
            ("row6", sq, sql.fused_squeezeformer_layer, {"conv_ln": False})):
        lyr = lyr.to(dev).eval()
        for dt in (torch.float32, bf):
            with torch.no_grad():
                posp = lyr.self_attn.linear_pos(
                    sinusoid_position_encoding(r, 256).to(dt))
                pk = lyr.chunk_packed_params(dt)

                def call(xd=x.to(dt), posp=posp, pk=pk, fn=fn, lyr=lyr,
                         extra=extra):
                    return fn(xd, lens, posp, pk, n_head=4,
                              ksize=lyr.cnn_module_kernel, causal=True,
                              **extra)

                key = f"{name}_{'bf16' if dt == bf else 'f32'}"
                digests[key] = _digest([call()])
                ms[key] = _ms(call)
    return {"digests": digests, "ms": ms, "bf16_err_roundings": err,
            "kernels": kernels}


def main():
    if not torch.cuda.is_available():
        raise SystemExit("kernel_digest: CUDA is not available")
    if "--ctc-only" in sys.argv[1:]:
        print(json.dumps({"ctc_loss": ctc_row(torch.device("cuda")),
                          "card": _smi()}), flush=True)
        return
    if "--train-bf16" in sys.argv[1:]:
        torch.backends.cuda.matmul.allow_tf32 = False
        print(json.dumps({"train_bf16": train_bf16_rows(
            torch.device("cuda")), "card": _smi()}), flush=True)
        return
    if "--flash" in sys.argv[1:]:
        torch.backends.cuda.matmul.allow_tf32 = False
        print(json.dumps({"flash": flash_rows(torch.device("cuda")),
                          "card": _smi()}), flush=True)
        return
    from masr_tpu_torch.models.conformer import ConformerEncoderLayer
    from masr_tpu_torch.models.embedding import sinusoid_position_encoding
    from masr_tpu_torch.models.weights import seeded_state_dict
    from masr_tpu_torch.ops.cuda import build
    from masr_tpu_torch.ops.cuda import chunk_layer as ck
    from masr_tpu_torch.ops.cuda import conformer_layer as cl
    from masr_tpu_torch.ops.cuda import conformer_layer_train as clt
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    build.build(["conformer_layer", "chunk_layer", "conformer_layer_train"])
    layer = ConformerEncoderLayer(256, 4, 2048, cnn_module_kernel=15,
                                  causal=True)
    layer.load_state_dict(seeded_state_dict(layer, seed=7))
    layer = layer.to(dev).eval()
    g = torch.Generator().manual_seed(8)
    digests, ms, kernels, invariant, matmul, host = {}, {}, {}, {}, {}, {}
    split = {}
    B, T = 8, 299
    lens = torch.tensor([299, 281, 250, 220, 180, 150, 90, 33],
                        dtype=torch.int32, device=dev)
    x = torch.randn(B, T, 256, generator=g).to(dev)
    r = torch.arange(T, device=dev)
    with torch.no_grad():
        posp = layer.self_attn.linear_pos(sinusoid_position_encoding(r, 256))
        packed = layer.packed_params()
        # the layer's cached pack, with the tensor-core arrays where the
        # tree has them (a tree whose row 1 ignores them reads the rest)
        packed_c = getattr(layer, "chunk_packed_params",
                           layer.packed_params)()
        u = slice(2, 3)

        def row1(s=slice(None)):
            return cl.fused_conformer_layer(x[s], lens[s], posp, packed_c,
                                            n_head=4, ksize=15, causal=True)

        y = row1()
        digests["fused_conformer_layer"] = _digest([y])
        y1 = row1(u)
        digests["fused_conformer_layer_B1"] = _digest([y1])
        invariant["fused_conformer_layer"] = _same_bits([y1], [y[u]])
        ms["fused_conformer_layer"] = _ms(row1)
        host["fused_conformer_layer"] = _host_ms(row1)
        kernels["fused_conformer_layer"] = _kernels(row1)
        split["fused_conformer_layer"] = _launch_split(row1)
        matmul["fused_conformer_layer"] = _matmul(
            _full_products(B * T, 256, 2048), dev)

        N, c, C = 32, 16, 256
        xc = torch.randn(N, c, 256, generator=g).to(dev)
        att = (0.5 * torch.randn(N, 4, C, 128, generator=g)).to(dev)
        cnn = (0.5 * torch.randn(N, 14, 256, generator=g)).to(dev)

        def i32(v):
            return torch.tensor(v, dtype=torch.int32, device=dev)

        clens = i32([(0, 5, 100, C)[s % 4] for s in range(N)])
        wptrs = i32([(37 * s) % C for s in range(N)])
        active = i32([0 if s in (3, 10, 17, 29) else 1 for s in range(N)])
        table = ck.make_chunk_pos_table(layer.self_attn.linear_pos.weight, C,
                                        8192)
        starts = ck.clamp_pos_starts(i32([C + 64 * s for s in range(N)]),
                                     8192, C + c)
        a, n = att.clone(), cnn.clone()
        one = slice(7, 8)
        a1, n1 = att[one].clone(), cnn[one].clone()

        def row2(a=a, n=n, s=slice(None)):
            return ck.fused_chunk_layer(xc[s], table, starts[s], a, n,
                                        clens[s], wptrs[s], active[s],
                                        packed_c, n_head=4, ksize=15)

        def row2_b1():
            return row2(a1, n1, one)

        y = row2()
        digests["fused_chunk_layer"] = _digest([y, a, n])
        y1 = row2_b1()
        digests["fused_chunk_layer_B1"] = _digest([y1, a1, n1])
        invariant["fused_chunk_layer"] = _same_bits(
            [y1, a1, n1], [y[one], a[one], n[one]])
        for name, fn in (("fused_chunk_layer", row2),
                         ("fused_chunk_layer_B1", row2_b1)):
            ms[name] = _ms(fn)
            host[name] = _host_ms(fn)
            kernels[name] = _kernels(fn)
            split[name] = _launch_split(fn)
        for b in (N, 1):
            matmul[f"fused_chunk_layer_B{b}"] = _matmul(
                _chunk_products(b, c, 256, 2048, 15), dev)

    rc, cc = r[:, None] // 16, r[None, :] // 16
    mask = ((cc <= rc) & (cc >= rc - 4))[None] & \
        (r[None, None, :] < lens[:, None, None])
    seeds = torch.randint(-2 ** 31, 2 ** 31 - 1, (B,), generator=g,
                          dtype=torch.int32).to(dev)
    w = torch.randn(B, T, 256, generator=g).to(dev)

    def train_layer(name, fn, packed, posp, ksize):
        """Digest and time one training-layer kernel, forward and
        backward."""
        leaves = {"x": x.clone().requires_grad_(True),
                  "posp": posp.clone().requires_grad_(True),
                  **{k: v.detach().clone().requires_grad_(True)
                     for k, v in packed.items()}}

        def fwd():
            return fn(leaves["x"], mask, seeds, lens, leaves["posp"],
                      {k: leaves[k] for k in packed}, layer=5, n_head=4,
                      ksize=ksize, causal=True, rate=0.1, att_rate=0.1)

        y = fwd()
        (y * w).sum().backward(retain_graph=True)
        digests[name] = _digest(
            [y] + [leaves[k].grad for k in sorted(leaves)])
        ms[name + "_fwd"] = _ms(fwd)
        ms[name + "_bwd"] = _ms(lambda: y.backward(w, retain_graph=True))
        kernels[name] = _kernels(lambda: fwd().backward(w))

    train_layer("fused_conformer_layer_train",
                clt.fused_conformer_layer_train, packed, posp, 15)
    try:
        from masr_tpu_torch.models.squeezeformer import \
            SqueezeformerEncoderLayer
        from masr_tpu_torch.ops.cuda import squeezeformer_layer as sql
        from masr_tpu_torch.ops.cuda import squeezeformer_layer_train as sqt
    except ImportError:     # a tree from before the Squeezeformer's training
        sqt = None
    if sqt is not None:
        build.build(["squeezeformer_layer", "squeezeformer_layer_train"])
        bn = SqueezeformerEncoderLayer(256, 4, 2048, 31, "batch_norm", True)
        bn.load_state_dict(seeded_state_dict(bn, seed=10))
        bn = bn.to(dev).eval()
        ln = SqueezeformerEncoderLayer(256, 4, 2048, 31, "layer_norm", True)
        ln.load_state_dict(seeded_state_dict(ln, seed=13))
        ln = ln.to(dev).eval()
        # full rate (T'=299) and half rate (T'=150, lens halved rounding
        # up, as the time reduction gives); BatchNorm and layer_norm conv
        for norm, lyr in (("", bn), ("_ln", ln)):
            for rate, Tr in (("", T), ("_half", (T + 1) // 2)):
                name = f"fused_squeezeformer_layer{norm}{rate}"
                lens_r = (lens + 1) // 2 if rate else lens
                xr = x[:, :Tr].contiguous()
                with torch.no_grad():
                    posp_r = lyr.self_attn.linear_pos(
                        sinusoid_position_encoding(r[:Tr], 256))
                    pk = getattr(lyr, "chunk_packed_params",
                                 lyr.packed_params)()

                    def row6(s=slice(None), xr=xr, lens_r=lens_r,
                             posp_r=posp_r, pk=pk, lyr=lyr):
                        return sql.fused_squeezeformer_layer(
                            xr[s], lens_r[s], posp_r, pk, n_head=4, ksize=31,
                            causal=True, conv_ln=lyr.conv_ln)

                    y = row6()
                    digests[name] = _digest([y])
                    y1 = row6(u)
                    digests[name + "_B1"] = _digest([y1])
                    invariant[name] = _same_bits([y1], [y[u]])
                    ms[name] = _ms(row6)
                    host[name] = _host_ms(row6)
                    kernels[name] = _kernels(row6)
                    split[name] = _launch_split(row6)
                    if not norm:
                        matmul[name] = _matmul(
                            _full_products(B * Tr, 256, 2048), dev)
        try:
            from masr_tpu_torch.ops.cuda import chunk_layer_sq as cks
        except ImportError:
            cks = None
        if cks is not None:
            build.build(["chunk_layer_sq"])
            N, D, H = 32, 256, 4
            g8 = torch.Generator().manual_seed(11)
            for rate, rep in (("full", 1), ("half", 2)):
                c, C = 16 // rep, 256 // rep
                xs = torch.randn(N, c, D, generator=g8).to(dev)
                ring = (0.5 * torch.randn(N, H, C * rep, 2 * D // H,
                                          generator=g8)).to(dev)
                conv = (0.5 * torch.randn(N, 30, D, generator=g8)).to(dev)
                pos = torch.randn(N * (C + c), D, generator=g8).to(dev)
                starts = torch.arange(N, dtype=torch.int32,
                                      device=dev) * (C + c)

                def i32(v):
                    return torch.tensor(v, dtype=torch.int32, device=dev)

                sl = i32([(0, 5, C // 2, C)[s % 4] for s in range(N)])
                wp = i32([(C - 3 - 7 * s) % C for s in range(N)])
                act = i32([0 if s in (3, 10, 17, 29) else 1
                           for s in range(N)])
                ring_k, conv_k = ring.clone(), conv.clone()
                one = slice(7, 8)
                ring_1, conv_1 = ring[one].clone(), conv[one].clone()
                # slot 7's position window starts at row 0 of its own call
                pos_1 = pos[7 * (C + c):8 * (C + c)]
                sq_packed_c = getattr(bn, "chunk_packed_params",
                                      bn.packed_params)()

                def row8(ring_k=ring_k, conv_k=conv_k, xs=xs, pos=pos,
                         starts=starts, sl=sl, wp=wp, act=act, rep=rep):
                    with torch.no_grad():
                        return cks.fused_chunk_layer_sq(
                            xs, pos, starts, ring_k, conv_k, sl, wp, act,
                            sq_packed_c, n_head=H, ksize=31,
                            conv_ln=False, rep=rep)

                def row8_b1(row8=row8, xs=xs, sl=sl, wp=wp, act=act,
                            ring_1=ring_1, conv_1=conv_1, pos_1=pos_1):
                    return row8(ring_1, conv_1, xs[one], pos_1,
                                starts[:1], sl[one], wp[one], act[one])

                name = f"fused_chunk_layer_sq_{rate}"
                y = row8()
                digests[name] = _digest([y, ring_k, conv_k])
                y1 = row8_b1()
                digests[name + "_B1"] = _digest([y1, ring_1, conv_1])
                invariant[name] = _same_bits(
                    [y1, ring_1, conv_1],
                    [y[one], ring_k[one], conv_k[one]])
                for nm, fn in ((name, row8), (name + "_B1", row8_b1)):
                    ms[nm] = _ms(fn)
                    host[nm] = _host_ms(fn)
                    kernels[nm] = _kernels(fn)
                    split[nm] = _launch_split(fn)
                for b in (N, 1):
                    matmul[f"{name}_B{b}"] = _matmul(
                        _chunk_products(b, c, D, 2048, 31), dev)
        sq = SqueezeformerEncoderLayer(256, 4, 2048, 31, "layer_norm", True)
        sq.load_state_dict(seeded_state_dict(sq, seed=9))
        sq = sq.to(dev)
        with torch.no_grad():
            sq_posp = sq.self_attn.linear_pos(sinusoid_position_encoding(
                r, 256))
            sq_packed = sq.packed_params()
        train_layer("fused_squeezeformer_layer_train",
                    sqt.fused_squeezeformer_layer_train, sq_packed,
                    sq_posp, 31)
    try:
        from masr_tpu_torch.ops.cuda import rel_pos_attention as rpa
    except ImportError:     # a tree from before the flash attention
        rpa = None
    if rpa is not None:
        build.build(["rel_pos_attention"])
        from masr_tpu_torch.ops.masks import add_optional_chunk_mask
        Tf = 1500
        flens = torch.tensor([1500, 1400, 1300, 1200, 1100, 1000, 800, 0],
                             device=dev)
        pad = (torch.arange(Tf, device=dev)[None, :] < flens[:, None])
        fmask = add_optional_chunk_mask(Tf, pad[:, None, :], False, False,
                                        -1, 16, -1)
        q, k, v = (torch.randn(B, 4, Tf, 64, generator=g).to(dev)
                   for _ in range(3))
        p = torch.randn(4, Tf, 64, generator=g).to(dev)
        bu, bv = (0.1 * torch.randn(4, 64, generator=g).to(dev)
                  for _ in range(2))

        def row5():
            return rpa.rel_pos_flash_attention(q, k, v, p, bu, bv, fmask)

        with torch.no_grad():
            digests["rel_pos_flash_attention"] = _digest([row5()])
            ms["rel_pos_flash_attention"] = _ms(row5)
            kernels["rel_pos_flash_attention"] = _kernels(row5)
    ctc = ctc_row(dev)
    digests["ctc_loss"] = ctc.pop("digest")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(json.dumps({"digests": digests, "ms": ms, "card": card,
                      "kernels": kernels, "batch_invariant": invariant,
                      "matmul": matmul, "host_ms": host,
                      "launch_split": split, "ctc_loss": ctc}),
          flush=True)


if __name__ == "__main__":
    main()
