"""Measure the chain shapes of the CTC kernel (row 4) on the card.

    python3 -m masr_tpu_torch.bench.ctc_probe

Builds copies of csrc/ctc_loss.cu under build/probe/ctc/ with other
constants: the states a lane holds (kMaxK: a chain of S = 161 states then
runs on one warp of 6 states a lane, or on 2 or 3 warps with a block
barrier a step) and the frames of log-probs loaded ahead (kAhead); and,
for timing only (their results are wrong), without a step's stores or
without its renormalisation. For each, at chip_smoke's CTC shape (B=8,
T'=299, V=4000, S=161), in the order package, variants, package: the
forward C entry's CUDA-event ms with the beta chains (20 calls), the
device ms of each of its kernels (torch.profiler), and a digest of the NLL
and the chains' f64 offsets (a shape moves no sum, so the shape variants
should agree). One JSON line with the card's name and power limit. The
package is not changed.
"""
import ctypes
import json
import os
import shutil
import subprocess

import torch

from masr_tpu_torch.bench.kernel_digest import _digest, _kernels, _ms

VARIANTS = {
    "package": {},
    "k4_warps2": {"kMaxK = 8;": "kMaxK = 4;",
                  "kMaxWarps = 8;": "kMaxWarps = 16;"},
    "k3_warps2": {"kMaxK = 8;": "kMaxK = 3;",
                  "kMaxWarps = 8;": "kMaxWarps = 22;"},
    "k2_warps3": {"kMaxK = 8;": "kMaxK = 2;",
                  "kMaxWarps = 8;": "kMaxWarps = 32;"},
    "ahead4": {"kAhead = 8;": "kAhead = 4;"},
    "ahead12": {"kAhead = 8;": "kAhead = 12;"},
    # timing only, wrong results: what a step's stores and its
    # renormalisation cost
    "no_store": {"if (act && s0 + i < S) out[(size_t)f * S + s0 + i] = v[i];":
                 ""},
    "no_renorm": {"      pm = warp_max(pm);\n      const int par": "      "
                  "const int par",
                  "r = k >= 2 ? m_prev - r_prev : 0.f;\n      // M_{k-1}":
                  "r = 0.f;\n      // M_{k-1}"},
}


def _build():
    """→ {variant: ctypes library} built from patched copies of csrc/."""
    from masr_tpu_torch.ops.cuda import build
    root = os.path.join(os.path.dirname(build.BUILD_DIR), "probe", "ctc")
    shutil.rmtree(root, ignore_errors=True)
    procs = {}
    for name, patch in VARIANTS.items():
        src = os.path.join(root, name)
        shutil.copytree(build.CSRC_DIR, src)
        path = os.path.join(src, "ctc_loss.cu")
        with open(path) as f:
            text = f.read()
        for old, new in patch.items():
            if text.count(old) != 1:
                raise RuntimeError(f"{old!r} not found once")
            text = text.replace(old, new)
        with open(path, "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o",
             os.path.join(src, "ctc.so"), path],
            stdout=subprocess.DEVNULL, stderr=subprocess.STDOUT)
    libs = {}
    for name, proc in procs.items():
        if proc.wait() != 0:
            raise RuntimeError(f"nvcc failed for variant {name}")
        lib = ctypes.CDLL(os.path.join(root, name, "ctc.so"))
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.masr_ctc_forward.restype = I
        lib.masr_ctc_forward.argtypes = [P] * 6 + [I] * 6 + [P]
        lib.masr_ctc_scratch_bytes.restype = ctypes.c_longlong
        lib.masr_ctc_scratch_bytes.argtypes = [I] * 3
        libs[name] = lib
    return libs


def main():
    if not torch.cuda.is_available():
        raise SystemExit("ctc_probe: CUDA is not available")
    dev = torch.device("cuda")
    libs = _build()
    g = torch.Generator().manual_seed(6)
    T, V, L = 299, 4000, 80
    label_lens = torch.tensor([5, 10, 15, 20, 25, 30, 40, 80],
                              dtype=torch.int32)
    lens = torch.tensor([33, 90, 150, 180, 220, 250, 281, T],
                        dtype=torch.int32)
    B = len(label_lens)
    x = (2 * torch.randn(B, T, V, generator=g)).to(dev)
    labels = torch.randint(1, V - 1, (B, L), generator=g)
    labels[torch.arange(L)[None] >= label_lens[:, None]] = 0
    labels, lens, label_lens = (labels.to(dev, torch.int32), lens.to(dev),
                                label_lens.to(dev))
    nll = torch.empty(B, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    out = []
    for name in ["package"] + [n for n in VARIANTS if n != "package"] + [
            "package"]:
        lib = libs[name]
        scratch = torch.zeros(lib.masr_ctc_scratch_bytes(B, T, L),
                              dtype=torch.uint8, device=dev)

        def fwd(lib=lib, scratch=scratch):
            err = lib.masr_ctc_forward(
                x.data_ptr(), labels.data_ptr(), lens.data_ptr(),
                label_lens.data_ptr(), nll.data_ptr(), scratch.data_ptr(),
                B, T, V, L, 0, 1, stream)
            if err:
                raise RuntimeError(f"{name}: CUDA error {err}")

        fwd()
        torch.cuda.synchronize()
        # the NLL and the chains' offsets, which lead the scratch
        out.append({"variant": name, "ms": _ms(fwd),
                    "kernels": _kernels(fwd),
                    "digest": _digest([nll, scratch[:B * T * 16]])})
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(json.dumps({"card": card, "runs": out}), flush=True)


if __name__ == "__main__":
    main()
