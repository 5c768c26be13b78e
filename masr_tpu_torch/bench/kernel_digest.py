"""Digest and time the port's kernels on the card, to compare two trees.

    python3 -m masr_tpu_torch.bench.kernel_digest

Runs the three Conformer layer kernels of the package importable from the
working directory on fixed seeded inputs at the flagship width (D=256, 4
heads, FFN 2048, conv 15):
  - fused_conformer_layer at B=8, T'=299, lens 299..33;
  - fused_chunk_layer at B=32, c=16, C=256, table positions, cache_len
    {0, 5, 100, 256}, four inactive slots;
  - fused_conformer_layer_train, forward and backward, at B=8, T'=299 with
    a dynamic-chunk mask and dropout 0.1;
and, in a tree that has them, fused_squeezeformer_layer (the
Squeezeformer's width: conv 31, BatchNorm conv) and
fused_squeezeformer_layer_train (layer_norm conv) on the same inputs,
fused_chunk_layer_sq at B=32 at full rate (c=16, C=256) and half rate (c=8,
C=128 on the full-resolution ring), and
rel_pos_flash_attention (4 heads, d_k 64) at B=8, T'=1500 under a static
chunk of 16 with lens 1500..800 and 0 (rows that see no key).
It prints one JSON line: a sha256 digest of each kernel's output bytes
(outputs, updated caches, grads), each kernel's CUDA-event time over 20
calls, the card's name and power limit, and, for the training layers
(forward + backward) and the flash attention, the device time per call of
each CUDA kernel they launch (torch.profiler). Two trees whose digests are
equal computed the same bits; run both on one card, one after the other
in the order A, B, B, A, to compare their times. Uses only entry points
that every tree since the training slice has, so it can be copied into
an older tree.
"""
import hashlib
import json
import subprocess

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


def main():
    if not torch.cuda.is_available():
        raise SystemExit("kernel_digest: CUDA is not available")
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
    digests, ms, kernels = {}, {}, {}
    B, T = 8, 299
    lens = torch.tensor([299, 281, 250, 220, 180, 150, 90, 33],
                        dtype=torch.int32, device=dev)
    x = torch.randn(B, T, 256, generator=g).to(dev)
    r = torch.arange(T, device=dev)
    with torch.no_grad():
        posp = layer.self_attn.linear_pos(sinusoid_position_encoding(r, 256))
        packed = layer.packed_params()

        def row1():
            return cl.fused_conformer_layer(x, lens, posp, packed, n_head=4,
                                            ksize=15, causal=True)

        digests["fused_conformer_layer"] = _digest([row1()])
        ms["fused_conformer_layer"] = _ms(row1)

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

        def row2(a=a, n=n):
            return ck.fused_chunk_layer(xc, table, starts, a, n, clens,
                                        wptrs, active, packed, n_head=4,
                                        ksize=15)

        digests["fused_chunk_layer"] = _digest([row2(), a, n])
        ms["fused_chunk_layer"] = _ms(row2)

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
        with torch.no_grad():
            bn_posp = bn.self_attn.linear_pos(sinusoid_position_encoding(
                r, 256))

            def row6():
                return sql.fused_squeezeformer_layer(
                    x, lens, bn_posp, bn.packed_params(), n_head=4, ksize=31,
                    causal=True, conv_ln=False)

            digests["fused_squeezeformer_layer"] = _digest([row6()])
            ms["fused_squeezeformer_layer"] = _ms(row6)
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

                def row8(ring_k=ring_k, conv_k=conv_k, xs=xs, pos=pos,
                         starts=starts, sl=sl, wp=wp, act=act, rep=rep):
                    with torch.no_grad():
                        return cks.fused_chunk_layer_sq(
                            xs, pos, starts, ring_k, conv_k, sl, wp, act,
                            bn.packed_params(), n_head=H, ksize=31,
                            conv_ln=False, rep=rep)

                name = f"fused_chunk_layer_sq_{rate}"
                digests[name] = _digest([row8(), ring_k, conv_k])
                ms[name] = _ms(row8)
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
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(json.dumps({"digests": digests, "ms": ms, "card": card,
                      "kernels": kernels}),
          flush=True)


if __name__ == "__main__":
    main()
