"""Tensor parallelism (port of masr_tpu/parallel/tp.py): Megatron-style
rules over the port's (upstream MASR) parameter names, and each rank's
slice of the ruled parameters and of their optimizer moments.

The rules are masr_tpu's TP_RULES in torch's layout. A flax Dense kernel
is (in, out) and a torch Linear weight (out, in), so flax's column split
P(None, "model") of linear_q / k / v / pos and w_1 is dim 0 of the torch
weight, and the row split P("model", None) of linear_out and w_2 is dim
1; their biases and pos_bias_u / v (heads, d_k) split dim 0 in both. A
dimension the model axis does not divide stays whole (tp.py:74-83).

The step (training/train_state.py), as masr_tpu runs its kernel route
(masr_tpu/models/conformer.py:951-959, "TP-sharded params are gathered at
the boundary, FSDP-style", the batch split over every mesh axis): the
model holds whole parameters and runs unchanged, kernels included, on the
rank's rows; the grads are averaged over every rank; each rank keeps the
slice of its model index of every ruled grad and runs the optimizer on
its slices, so the ruled leaves' optimizer memory falls as 1/tp; the
slices are gathered over the model axis into the whole parameters after
each update. A checkpoint holds the whole parameters and whole moments
(`gather_opt_state`), the file one process writes; loading slices them
again (`shard_opt_state`).
"""
import re

import torch

from masr_tpu_torch.parallel import mesh

# (name regex, split dim of the torch tensor): first match wins; the rest
# stays whole
TP_RULES = [
    (re.compile(r".*\.(linear_q|linear_k|linear_v|linear_pos)\.weight$"),
     0),
    (re.compile(r".*\.(linear_q|linear_k|linear_v)\.bias$"), 0),
    (re.compile(r".*\.pos_bias_[uv]$"), 0),
    (re.compile(r".*\.linear_out\.weight$"), 1),
    (re.compile(r".*\.w_1\.weight$"), 0),
    (re.compile(r".*\.w_1\.bias$"), 0),
    (re.compile(r".*\.w_2\.weight$"), 1),
]


def split_dim(name, shape, tp):
    """The dim `tp` splits of parameter `name` of `shape`, or None."""
    for pattern, dim in TP_RULES:
        if pattern.match(name):
            if dim < len(shape) and shape[dim] % tp == 0:
                return dim
            return None
    return None


def param_shardings(model, tp):
    """{name: split dim or None} of the model's trainable parameters."""
    return {n: split_dim(n, tuple(p.shape), tp)
            for n, p in model.named_parameters() if p.requires_grad}


def _slice(t, dim, index, tp):
    n = t.shape[dim] // tp
    return t.narrow(dim, index * n, n)


class Shards(object):
    """The rank's slices of the ruled trainable parameters of `params` (a
    list of (name, parameter), the optimizer's order): `slices[i]` the leaf
    that stands in for params[i] in the optimizer (absent: the whole
    parameter)."""

    def __init__(self, params, grid):
        self.grid = grid
        self.params = [p for _, p in params]
        self.dims = {}
        self.slices = {}
        for i, (name, p) in enumerate(params):
            d = split_dim(name, tuple(p.shape), grid.tp)
            if d is not None and grid.tp > 1 and p.requires_grad:
                self.dims[i] = d
                self.slices[i] = torch.nn.Parameter(
                    _slice(p.detach(), d, grid.model, grid.tp).clone())

    def opt_params(self):
        """The optimizer's leaves, in the order of `params`."""
        return [self.slices.get(i, p) for i, p in enumerate(self.params)]

    def take_grads(self):
        """Each slice's grad from its parameter's (whole, averaged) grad."""
        for i, s in self.slices.items():
            p = self.params[i]
            s.grad = _slice(p.grad, self.dims[i], self.grid.model,
                            self.grid.tp).clone()

    @torch.no_grad()
    def reset(self):
        """Each slice from its whole parameter."""
        for i, s in self.slices.items():
            s.copy_(_slice(self.params[i].detach(), self.dims[i],
                           self.grid.model, self.grid.tp))

    @torch.no_grad()
    def gather(self):
        """The whole parameters from the slices over the model axis."""
        for i, s in self.slices.items():
            self.params[i].copy_(mesh.all_gather(s.detach(), self.dims[i],
                                                 self.grid.model_group))


def shard_params(model, grid):
    """The rank's Shards of the model's parameters (model.parameters()
    order: Shards.opt_params() is what the optimizer is built over)."""
    return Shards(list(model.named_parameters()), grid)


def _moments(state, shape):
    """Keys of an optimizer state entry that are parameter-shaped."""
    return [k for k, v in state.items() if isinstance(v, torch.Tensor)
            and v.dim() > 0 and tuple(v.shape) == tuple(shape)]


def gather_opt_state(opt_state, shards):
    """An optimizer state_dict over the slices → the one over whole
    parameters (every moment gathered over the model axis); collective."""
    out = {"state": {}, "param_groups": opt_state["param_groups"]}
    for i, st in opt_state["state"].items():
        st = dict(st)
        if i in shards.slices:
            for k in _moments(st, shards.slices[i].shape):
                st[k] = mesh.all_gather(st[k], shards.dims[i],
                                        shards.grid.model_group)
        out["state"][i] = st
    return out


def shard_opt_state(opt_state, shards):
    """An optimizer state_dict over whole parameters → the rank's (every
    moment of a ruled parameter sliced)."""
    out = {"state": {}, "param_groups": opt_state["param_groups"]}
    for i, st in opt_state["state"].items():
        st = dict(st)
        if i in shards.slices:
            for k in _moments(st, shards.params[i].shape):
                st[k] = _slice(st[k], shards.dims[i], shards.grid.model,
                               shards.grid.tp).clone()
        out["state"][i] = st
    return out
