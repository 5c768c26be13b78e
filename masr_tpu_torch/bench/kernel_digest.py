"""Digest and time the port's kernels on the card, to compare two trees.

    python3 -m masr_tpu_torch.bench.kernel_digest [--ctc-only]

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
row alone).
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
    hashes as a marker)."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(b"none" if t is None
                 else t.detach().contiguous().cpu().numpy().tobytes())
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


def main():
    if not torch.cuda.is_available():
        raise SystemExit("kernel_digest: CUDA is not available")
    if "--ctc-only" in sys.argv[1:]:
        print(json.dumps({"ctc_loss": ctc_row(torch.device("cuda")),
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
