"""The training layers' bf16 product alone: the Hopper kernel and its plain
twin.

Every product of the bf16 mode of rows 3 and 7 (masr_tpu's `_mm`,
`_mm_nt`, `_mm_tn` at compute dtype bf16,
masr_tpu/ops/pallas/conformer_layer_train.py:79-95) runs
masr_tpu_torch/csrc/train_wgmma.cuh's `tw_gemm_kernel` inside the layer
kernels; its header says how (TMA tiles of bf16 operands, `wgmma`, the
split over K of the weight grads). `train_product_bf16` launches that
product on its own through `masr_train_product_bf16`
(csrc/conformer_layer_train.cu), so the card tests can hold it against its
plain twin over transposes, batches, strides, ragged edges, split-K and
each epilogue, and a benchmark can time it.

Operands are bf16 tensors (..., rows, inner) with a unit inner stride and
up to two batch dims: batch matrix z = i1 * n2 + i2 (a stride of 0
broadcasts an operand, as posp across utterances). A is (..., M, K), or
(..., K, M) with `ta`; B is (..., K, N), or (..., N, K) with `tb`. The
outputs `out` (f32) and `out_bf16` (bf16, rounded to nearest even) are
(..., M, N) views written in place, R, pre and aux of out's shape and
strides. The epilogue is training.cuh's `Epi`: v = alpha acc + bias[n];
pre = v; v = SiLU(v) (act 1) or v dSiLU(aux) (act 2); the dropout hash's
mask of (seeds[b], layer, site, row0 + b, t, n) with b, t = divmod(m, T);
0 where t >= lens[b]; out = R + res_scale v, rounded to bf16 values with
`round_c`. `split`: the weight grads' path (ta, not tb, no epilogue), the
K rows split into slices summed in slice order.

A CPU tensor takes `train_product_plain`; a CUDA tensor launches the
kernel or raises. `train_product_bf16.launches` counts the launches.
"""
import ctypes

import torch
import torch.nn.functional as F

from masr_tpu_torch.ops.dropout_hash import dropout_mask, dropout_params

BF16 = torch.bfloat16


def geometry(t):
    """(ld, s1, s2, div) of a matrix or batch of matrices t (..., rows,
    inner), unit inner stride, 0 to 2 batch dims, and its batch count: the
    layout csrc/train_wgmma.cuh's BMat and Batch describe (matrix z at (z //
    div) s1 + (z % div) s2 elements)."""
    if t.dim() < 2 or t.dim() > 4:
        raise ValueError(f"a product operand has 2 to 4 dims, got "
                         f"{tuple(t.shape)}")
    if t.stride(-1) != 1:
        raise ValueError("a product operand's rows must be contiguous")
    ld = t.stride(-2)
    lead = tuple(t.shape[:-2])
    if not lead:
        return (ld, 0, 0, 1), 1
    if len(lead) == 1:
        return (ld, t.stride(0), 0, 1), lead[0]
    return (ld, t.stride(0), t.stride(1), lead[1]), lead[0] * lead[1]


def _dims(a, b, ta, tb):
    M, K = (a.shape[-1], a.shape[-2]) if ta else (a.shape[-2], a.shape[-1])
    Kb, N = (b.shape[-1], b.shape[-2]) if tb else (b.shape[-2], b.shape[-1])
    if Kb != K:
        raise ValueError(f"op(A) is {M} x {K}, op(B) {Kb} x {N}")
    return M, N, K


def train_product_plain(a, b, *, ta=False, tb=False, bias=None, alpha=1.0,
                        R=None, res_scale=1.0, act=0, aux=None, seeds=None,
                        layer=0, site=0, rate=0.0, row0=0, lens=None, T=1,
                        round_c=False):
    """The product of bf16-rounded operands summed in f32, then the
    epilogue (module docstring), in plain PyTorch. → (out, pre), f32 (...,
    M, N)."""
    A = a.to(BF16).float()
    B = b.to(BF16).float()
    acc = (A.transpose(-1, -2) if ta else A) @ (B.transpose(-1, -2) if tb
                                                else B)
    v = alpha * acc + (bias if bias is not None else 0.0)
    pre = v
    if act == 1:
        v = F.silu(v)
    elif act == 2:
        s = torch.sigmoid(aux)
        v = v * (s * (1.0 + aux * (1.0 - s)))
    M, N = v.shape[-2:]
    m = torch.arange(M, device=v.device)
    if seeds is not None and rate > 0.0:
        mask = dropout_mask(seeds, layer, site,
                            torch.arange(T, device=v.device),
                            torch.arange(N, device=v.device), rate, row0)
        v = v * mask.reshape(-1, N)[:M]
    if lens is not None:
        ok = (m % T) < lens.to(v.device).long()[m // T]
        v = torch.where(ok[:, None], v, 0.0)
    out = (R if R is not None else 0.0) + res_scale * v
    if round_c:
        out = out.to(BF16).float()
    return out, pre


def _lib():
    from masr_tpu_torch.ops.cuda import build
    lib = build.load("conformer_layer_train")
    P, I, U, Fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, \
        ctypes.c_float
    fn = lib.masr_train_product_part_floats
    fn.restype = ctypes.c_size_t
    fn.argtypes = [I, I, I, I, P]
    fn = lib.masr_train_product_bf16
    fn.restype = I
    fn.argtypes = ([P, P, I, P, P, I, P, P, P] + [I] * 5 + [P, P, Fl, P, Fl,
                                                          P, I, P, P, I, I, U,
                                                          Fl, I, P, I, I, P])
    return lib


def _ptr(t):
    return t.data_ptr() if t is not None else None


def _geom_arg(g):
    """A host array of 4 int64 as the C entry's pointer argument."""
    return (ctypes.c_longlong * 4)(*g)


def train_product_bf16(a, b, *, ta=False, tb=False, out=None, out_bf16=None,
                       split=False, bias=None, alpha=1.0, R=None,
                       res_scale=1.0, pre=None, act=0, aux=None, seeds=None,
                       layer=0, site=0, rate=0.0, row0=0, lens=None, T=1,
                       round_c=False):
    """Write the product's epilogue into out (f32) and / or out_bf16 (bf16)
    and pre, as the module docstring says. A CPU tensor takes the plain
    twin; a CUDA tensor launches csrc/train_wgmma.cuh's kernel or
    raises."""
    if out is None and out_bf16 is None:
        raise ValueError("give out and / or out_bf16")
    if a.dtype != BF16 or b.dtype != BF16:
        raise ValueError("the operands are bf16")
    if a.device.type == "cpu":
        got, p = train_product_plain(
            a, b, ta=ta, tb=tb, bias=bias, alpha=alpha, R=R,
            res_scale=res_scale, act=act, aux=aux, seeds=seeds, layer=layer,
            site=site, rate=rate, row0=row0, lens=lens, T=T, round_c=round_c)
        for t, v in ((out, got), (out_bf16, got), (pre, p)):
            if t is not None:
                t.copy_(v)
        return
    if a.device.type != "cuda":
        raise ValueError(f"no kernel for device {a.device}")
    M, N, K = _dims(a, b, ta, tb)
    ga, na = geometry(a)
    gb, nb = geometry(b)
    c = out if out is not None else out_bf16
    gc, batch = geometry(c)
    if tuple(c.shape[-2:]) != (M, N) or na != batch or nb != batch:
        raise ValueError("operand and output batches or shapes disagree")
    for t in (out, out_bf16, R, pre, aux):
        if t is not None and (t.shape != c.shape or t.stride() != c.stride()
                              or t.device != a.device):
            raise ValueError("out, out_bf16, R, pre and aux share a layout")
    if split and (not ta or tb or (out is None) == (out_bf16 is None)):
        raise ValueError("split: A transposed, B not, one output")
    lib = _lib()
    ga, gb, gc = _geom_arg(ga), _geom_arg(gb), _geom_arg(gc)
    part = None
    if split:
        part = torch.empty(lib.masr_train_product_part_floats(
            M, N, K, batch, ctypes.addressof(gc)), dtype=torch.float32,
            device=a.device)
    thresh, keep = dropout_params(rate)
    with torch.cuda.device(a.device):
        err = lib.masr_train_product_bf16(
            a.data_ptr(), ctypes.addressof(ga), int(ta), b.data_ptr(),
            ctypes.addressof(gb), int(tb), _ptr(out), _ptr(out_bf16),
            ctypes.addressof(gc),
            M, N, K, batch, int(split), _ptr(part), _ptr(bias), float(alpha),
            _ptr(R), float(res_scale), _ptr(pre), int(act), _ptr(aux),
            _ptr(seeds), int(layer), int(site), thresh, keep, int(row0),
            _ptr(lens), int(T), int(round_c),
            torch.cuda.current_stream(a.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"train product kernel failed: CUDA error {err}")
    train_product_bf16.launches += 1


train_product_bf16.launches = 0
