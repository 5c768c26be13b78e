"""Measure the product choices of the full-context layer kernels (rows 1 and
6) on the card: the split of the FFN w_2's K and a 64 x 128 tile.

    python3 -m masr_tpu_torch.bench.full_context_probe

Runs row 1 (fused_conformer_layer, B=8, T'=299, lens 299..33) and row 6 at
the half rate (fused_squeezeformer_layer, BatchNorm conv, T'=150, the lens
halved rounding up) at the flagship widths, on the layers' cached serving
tensor-core pack:
  - plans: full_plan's largest part FULL_PART in 2048, 1024, 512 and 256
    floats, i.e. the w_2 in 1, 2, 4 or 8 parts (every other product has K =
    256 and one part);
  - tiles: the two kernels as built from the package (64 x 64 tiles), and
    built from a copy of csrc/ under build/probe/ in which gemm_sk takes a
    64 x 128 tile (4 warps of 32 x 64) for the wide products (N >= 768:
    q/k/v and FFN w_1) where such tiles fill the 132 SMs, timed in the
    order package, copy, copy, package.
For each it gives the CUDA-event ms of a layer call (20 back-to-back calls),
the device ms of each launch of one call (torch.profiler, in launch order)
and a digest of the output bits (the tile moves no element's sum order, so
the tile variants should agree), in one JSON line with the card's name and
power limit.
Timing only: the package's kernels are not changed.
"""
import ctypes
import json
import os
import shutil
import subprocess

import torch

from masr_tpu_torch.bench.kernel_digest import _digest, _launch_split, _ms

# gemm_sk's 64 x 64 rule, and the 64 x 128 rule the copy puts before it
TILE_RULE = ("  if ((long)((M + 63) / 64) * ((N + 63) / 64) * p.parts >= 96)\n"
             "    return gemm_sk_run<64, 64, 32, 32>")
WIDE_RULE = ("  if (N >= 768 && (long)((M + 63) / 64) * ((N + 127) / 128) *\n"
             "                     p.parts >= 132)\n"
             "    return gemm_sk_run<64, 128, 32, 64>(A, W, C, M, N, K, lda, "
             "ldc, p, sk, e,\n"
             "                                        stream);\n")


def _layers(dev):
    from masr_tpu_torch.models.conformer import ConformerEncoderLayer
    from masr_tpu_torch.models.embedding import sinusoid_position_encoding
    from masr_tpu_torch.models.squeezeformer import SqueezeformerEncoderLayer
    from masr_tpu_torch.models.weights import seeded_state_dict
    from masr_tpu_torch.ops.cuda import conformer_layer as cl
    from masr_tpu_torch.ops.cuda import squeezeformer_layer as sql
    g = torch.Generator().manual_seed(8)
    lens = torch.tensor([299, 281, 250, 220, 180, 150, 90, 33],
                        dtype=torch.int32, device=dev)
    x = torch.randn(8, 299, 256, generator=g).to(dev)
    calls = {}
    with torch.no_grad():
        cf = ConformerEncoderLayer(256, 4, 2048, cnn_module_kernel=15,
                                   causal=True)
        cf.load_state_dict(seeded_state_dict(cf, seed=7))
        cf = cf.to(dev).eval()
        posp = cf.self_attn.linear_pos(sinusoid_position_encoding(
            torch.arange(299, device=dev), 256))
        pk = cf.chunk_packed_params()
        calls["row1_T299"] = lambda: cl.fused_conformer_layer(
            x, lens, posp, pk, n_head=4, ksize=15, causal=True)
        sq = SqueezeformerEncoderLayer(256, 4, 2048, 31, "batch_norm", True)
        sq.load_state_dict(seeded_state_dict(sq, seed=10))
        sq = sq.to(dev).eval()
        xh, lh = x[:, :150].contiguous(), (lens + 1) // 2
        posh = sq.self_attn.linear_pos(sinusoid_position_encoding(
            torch.arange(150, device=dev), 256))
        spk = sq.chunk_packed_params()
        calls["row6_T150"] = lambda: sql.fused_squeezeformer_layer(
            xh, lh, posh, spk, n_head=4, ksize=31, causal=True,
            conv_ln=False)
    return calls


def _time(calls):
    with torch.no_grad():
        return {name: {"ms": _ms(fn), "launches": _launch_split(fn),
                       "digest": _digest([fn()])}
                for name, fn in calls.items()}


def _wide_entries():
    """The two layer kernels built from a copy of csrc/ whose gemm_sk takes
    a 64 x 128 tile for wide products. → {module name: typed C entry}."""
    from masr_tpu_torch.ops.cuda import build
    from masr_tpu_torch.ops.cuda.chunk_layer import typed_entry
    root = os.path.join(os.path.dirname(build.BUILD_DIR), "probe")
    src = os.path.join(root, "csrc")
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(build.CSRC_DIR, src)
    path = os.path.join(src, "serving.cuh")
    with open(path) as f:
        text = f.read()
    if text.count(TILE_RULE) != 1:
        raise RuntimeError("gemm_sk's 64 x 64 rule not found once")
    with open(path, "w") as f:
        f.write(text.replace(TILE_RULE, WIDE_RULE + TILE_RULE))
    procs = {name: subprocess.Popen(
        [build._nvcc(), *build.NVCC_FLAGS, "-o",
         os.path.join(root, name + ".so"), os.path.join(src, name + ".cu")],
        stdout=subprocess.DEVNULL, stderr=subprocess.STDOUT)
        for name in ("conformer_layer", "squeezeformer_layer")}
    for name, proc in procs.items():
        if proc.wait() != 0:
            raise RuntimeError(f"nvcc failed for the copy of {name}.cu")
    lib = {name: ctypes.CDLL(os.path.join(root, name + ".so"))
           for name in procs}
    return {"conformer_layer": typed_entry(
                lib["conformer_layer"].masr_conformer_layer_forward,
                15, 7, 2),
            "squeezeformer_layer": typed_entry(
                lib["squeezeformer_layer"].masr_sq_layer_forward, 17, 8, 2)}


def main():
    if not torch.cuda.is_available():
        raise SystemExit("full_context_probe: CUDA is not available")
    from masr_tpu_torch.ops.cuda import build
    from masr_tpu_torch.ops.cuda import conformer_layer as cl
    from masr_tpu_torch.ops.cuda import squeezeformer_layer as sql
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    build.build(["conformer_layer", "squeezeformer_layer"])
    calls = _layers(dev)
    kept = cl.FULL_PART
    plans = {}
    for part in (2048, 1024, 512, 256):
        cl.FULL_PART = part
        cl.full_plans.cache_clear()
        plans[f"w2_parts_{-(-2048 // part)}"] = _time(calls)
    cl.FULL_PART = kept
    cl.full_plans.cache_clear()

    wide = _wide_entries()
    package = {"conformer_layer": cl.chunk_entry, "squeezeformer_layer":
               sql.chunk_entry}

    def use(which):
        for mod, name in ((cl, "conformer_layer"),
                          (sql, "squeezeformer_layer")):
            mod.chunk_entry = (package[name] if which == "package"
                               else lambda *a, _fn=wide[name]: _fn)

    tiles = []
    try:
        for which in ("package", "64x128", "64x128", "package"):
            use(which)
            tiles.append({"tiles": which, **_time(calls)})
    finally:
        use("package")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(json.dumps({"card": card, "full_part": kept, "plans": plans,
                      "tiles": tiles}), flush=True)


if __name__ == "__main__":
    main()
