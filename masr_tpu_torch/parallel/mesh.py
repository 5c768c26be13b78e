"""Process groups and batch sharding (port of masr_tpu/parallel/mesh.py):
data parallelism over processes, launched as upstream MASR launches it,

    torchrun --nproc_per_node=N -m masr_tpu_torch.train --configs ...

which sets RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and MASTER_PORT.
`maybe_init_distributed` reads them (NCCL on the card, gloo on the CPU;
the CUDA device from LOCAL_RANK). With WORLD_SIZE unset or 1 and no group
made by the caller nothing is created, and the training path is the one
process's, collectives and all absent.

`make_mesh_2d(tensor_parallel)` places the rank in a (data, model) grid,
the model axis innermost as masr_tpu's (tp.py:48-57): rank = data x tp +
model. The batch is split over every rank (the rank's rows of the global
batch: `shard_batch`); each rank runs its kernels on its own rows, and the
grads are averaged over all ranks once per update
(training/train_state.py). Tensor parallelism (parallel/tp.py) keeps
each rank's slice of the ruled parameters and of their optimizer moments
and gathers the whole parameters over the model axis after each update.

masr_tpu's active-mesh registry and `fused_route_mesh` (mesh.py:70-114)
exist because GSPMD cannot partition a pallas_call, so its fused paths
shard_map over a registered mesh. Here every rank calls its kernels on
its own rows, so they have no counterpart. What stays is narrower: three
places deep in the model must know, during a train step over several
ranks, where the rank's rows sit in the global batch and that the batch
spans the ranks: the training kernels' dropout seeds and row offset
(ops/dropout_hash.py), the BatchNorm's statistics (models/convolution.py)
and the length-normalised attention loss's token count
(models/losses.py). The step grid (`step_grid`, read by `active`) carries
that to them for the length of one train step (training/train_state.py
train_step enters it), rather than an argument through every layer's
forward. Outside a step nothing is active, so an eval pass on rank 0
alone, or a forward after the process group is gone, runs no collective.

Collectives on CUDA tensors over gloo (several ranks on one card, where
NCCL refuses) go through host copies.
"""
import contextlib
import os

import numpy as np
import torch
import torch.distributed as dist

_GRID = None


class Grid(object):
    """The rank's place in the (data, model) grid and the groups of its
    axes: rank = data x tp + model; `model_group` holds the tp ranks that
    share the data index (None at tp = 1), `group` every rank (None: one
    process without a process group)."""

    def __init__(self, rank=0, world=1, tp=1, group=None, model_group=None):
        self.rank, self.world, self.tp = rank, world, tp
        self.model = rank % tp
        self.group, self.model_group = group, model_group

    @property
    def distributed(self):
        return self.group is not None


def maybe_init_distributed(device=None, backend=None, init_method=None):
    """Join torchrun's process group: RANK, WORLD_SIZE (and MASTER_ADDR /
    MASTER_PORT, or `init_method`, e.g. file://...). A group the caller
    made already is kept. WORLD_SIZE unset or 1 without init_method: no
    group. backend: NCCL for a CUDA device, gloo otherwise, unless given;
    LOCAL_RANK picks the CUDA device. → (rank, world)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    world = int(os.environ.get("WORLD_SIZE", "1") or 1)
    if world <= 1 and init_method is None:
        return 0, 1
    rank = int(os.environ.get("RANK", "0") or 0)
    device = torch.device(device) if device is not None else None
    if device is not None and device.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", "0") or 0)
        torch.cuda.set_device(local)
    if backend is None:
        backend = "nccl" if device is not None and \
            device.type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=init_method or "env://",
                            rank=rank, world_size=world)
    return rank, world


def local_device(device):
    """`device` with the CUDA index of LOCAL_RANK under torchrun."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None \
            and "LOCAL_RANK" in os.environ:
        return torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    return device


def make_mesh_2d(tensor_parallel=1):
    """The rank's Grid over the current process group (one process
    without one); raises where tensor_parallel does not divide the world
    size (tp.py:53-55). Every rank must call it (the model groups are made
    collectively)."""
    tp = int(tensor_parallel or 1)
    if dist.is_available() and dist.is_initialized():
        rank, world, group = dist.get_rank(), dist.get_world_size(), \
            dist.group.WORLD
    else:
        rank, world, group = 0, 1, None
    if tp < 1 or world % tp:
        raise ValueError(f"{world} ranks not divisible by "
                         f"tensor_parallel={tp}")
    model_group = None
    if group is not None and tp > 1:
        for d in range(world // tp):
            g = dist.new_group([d * tp + m for m in range(tp)])
            if d == rank // tp:
                model_group = g
    return Grid(rank, world, tp, group, model_group)


def make_mesh():
    """The data-parallel grid (tensor_parallel 1)."""
    return make_mesh_2d(1)


@contextlib.contextmanager
def step_grid(grid):
    """`grid` (a Grid, or None: one process) is the active grid inside the
    block, the one before it after the block."""
    global _GRID
    prev, _GRID = _GRID, grid
    try:
        yield grid
    finally:
        _GRID = prev


def active():
    """The active Grid (`step_grid`) when it spans a process group, else
    None."""
    return _GRID if _GRID is not None and _GRID.distributed else None


def batch_shard():
    """(index, count) of this rank's rows in the global batch: (rank,
    world) of the active grid, (0, 1) without one."""
    g = active()
    return (g.rank, g.world) if g is not None else (0, 1)


def shard_batch(batch, rank, world):
    """A global batch (dict of arrays or tensors, rows leading) → this
    rank's rows. Pads to a multiple of `world` with zero rows first, so a
    padded row has zero lengths and counts in the mean loss as masr_tpu's
    padded rows count (mesh.py:44-62)."""
    def take(x):
        B = x.shape[0]
        n = -(-B // world)
        if isinstance(x, torch.Tensor):
            if B % world:
                x = torch.cat([x, x.new_zeros((n * world - B,)
                                              + tuple(x.shape[1:]))])
        else:
            x = np.asarray(x)
            if B % world:
                x = np.concatenate([x, np.zeros((n * world - B,)
                                                + x.shape[1:], x.dtype)])
        return x[rank * n:(rank + 1) * n]

    return {k: take(v) for k, v in batch.items()}


def _gloo_host(group):
    return dist.get_backend(group) == "gloo"


def all_reduce(t, op=dist.ReduceOp.SUM, group=None):
    """In-place all-reduce of `t` over `group` (default: every rank),
    through a host copy for a CUDA tensor over gloo → t."""
    if t.is_cuda and _gloo_host(group):
        h = t.cpu()
        dist.all_reduce(h, op=op, group=group)
        t.copy_(h)
    else:
        dist.all_reduce(t, op=op, group=group)
    return t


def all_gather(t, dim, group):
    """The tensors `t` of the ranks of `group`, concatenated along `dim` in
    rank order."""
    n = dist.get_world_size(group)
    src = t.contiguous()
    if src.is_cuda and _gloo_host(group):
        h = src.cpu()
        parts = [torch.empty_like(h) for _ in range(n)]
        dist.all_gather(parts, h, group=group)
        return torch.cat(parts, dim=dim).to(t.device)
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=dim)


def broadcast(t, src=0, group=None):
    """In-place broadcast of rank `src`'s `t` → t."""
    if t.is_cuda and _gloo_host(group):
        h = t.cpu()
        dist.broadcast(h, src, group=group)
        t.copy_(h)
    else:
        dist.broadcast(t, src, group=group)
    return t


class _AllReduceSum(torch.autograd.Function):
    """Sum over every rank whose backward sums the grads over every rank
    (torch.distributed.nn.functional.all_reduce, with the gloo host copy
    of `all_reduce`)."""

    @staticmethod
    def forward(ctx, x):
        return all_reduce(x.clone())

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.clone())


def all_reduce_sum(x):
    """Differentiable sum of `x` over every rank."""
    return _AllReduceSum.apply(x)


def replicate(module, grid, src=0):
    """Broadcast rank `src`'s parameters and buffers to every rank of
    `grid` (a no-op for a grid without a process group, or None) →
    module."""
    if grid is None or not grid.distributed:
        return module
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            broadcast(t.data, src)
    return module
