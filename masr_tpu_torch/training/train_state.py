"""Train state and the train and eval steps (port of
masr_tpu/training/train_state.py: make_train_step :47-99, make_eval_step
:102).

One train step: loss → backward → non-finite skip → accum_grad
accumulation → at each accum_grad-th step one global-norm clip, one
optimizer step and one LR-schedule step. That is optax's
MultiSteps(chain(clip_by_global_norm, add_decayed_weights, adam)) as
masr_tpu builds it: grads are averaged over the micro-steps (Welford's
running mean, as MultiSteps), and a micro-step whose loss is not finite
contributes zero grads and leaves the parameters as they were, while the
accumulation count, and at a boundary the Adam moments, step count and
schedule, advance as in masr_tpu (train_state.py:82-90).

Randomness comes from explicit generators folded with the step, as
masr_tpu folds its key (:78): dropout and the training kernel's seeds from
a generator on the model's device, the dynamic chunk from one on the CPU,
and the on-device frontend's dither and masks from a third on the device.

Over several processes (parallel/mesh.py: a TrainState with a `grid`),
the step follows masr_tpu's global batch: each rank runs its rows, padded
first to the longest frame count of any rank (one all-reduce of the max,
so the dynamic chunk has the same range on every rank); one all-reduce of
the losses and the non-finite flags gives every rank the global mean loss
and one skip decision; the grads are averaged over the ranks once per
update, at the accum_grad boundary (one all-reduce of the flattened
accumulators: upstream's no_sync), before the global-norm clip, so the
clip and the update are the same on every rank. The model's forward and
backward run inside the grid's `mesh.step_grid`, which tells the dropout
seeds where the rank's rows sit and the BatchNorm that its statistics span
the ranks. With tensor parallelism (parallel/tp.py `Shards`) the optimizer
runs on the rank's slices of the ruled parameters, whose whole tensors
are gathered after the update.

With a frontend (ops/specaug.py make_device_frontend, the trainer's
dataset_conf.on_device_frontend) the batch's inputs are int16-scale
waveforms and their lengths samples: the train step runs the frontend in
training mode on the device before the model, the eval steps its
deterministic fbank (masr_tpu/training/train_state.py:52-56, :102-110).
"""
import torch

from masr_tpu_torch.parallel import mesh
from masr_tpu_torch.parallel import tp as tpmod

_MIX = 0x9E3779B97F4A7C15


def fold_seed(seed, step, stream):
    """A 63-bit seed for (seed, step, stream): splitmix64 of the three."""
    x = (int(seed) * _MIX + int(step) * 0xBF58476D1CE4E5B9
         + int(stream) * 0x94D049BB133111EB) & (2 ** 64 - 1)
    x ^= x >> 30
    x = (x * 0xBF58476D1CE4E5B9) & (2 ** 64 - 1)
    x ^= x >> 27
    x = (x * 0x94D049BB133111EB) & (2 ** 64 - 1)
    return (x ^ (x >> 31)) >> 1


def step_generators(seed, step, device):
    """→ (dropout generator on `device`, chunk generator on the CPU) for
    train step `step`."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(fold_seed(seed, step, 0))
    chunk = torch.Generator()
    chunk.manual_seed(fold_seed(seed, step, 1))
    return gen, chunk


def frontend_generator(seed, step, device):
    """The on-device frontend's generator on `device` for train step
    `step`."""
    gen = torch.Generator(device=torch.device(device))
    gen.manual_seed(fold_seed(seed, step, 2))
    return gen


def model_inputs(batch, frontend=None, generator=None, train=False):
    """The model's (inputs, input_lens): the batch's features, or the
    frontend's features of its waveforms."""
    if frontend is None:
        return batch["inputs"], batch["input_lens"]
    return frontend(batch["inputs"], batch["input_lens"], generator, train)


def batch_to(batch, device):
    """numpy collate dict → tensors on `device` (labels and lengths as
    int64 for the embedding and the masks)."""
    out = {"inputs": torch.as_tensor(batch["inputs"], dtype=torch.float32)}
    for k in ("input_lens", "labels", "label_lens"):
        out[k] = torch.as_tensor(batch[k]).long()
    return {k: v.to(device, non_blocking=True) for k, v in out.items()}


class TrainState(object):
    """The model, its optimizer and LR scheduler, and the accumulation
    state. `step` counts train steps (micro-steps), as masr_tpu's
    state.step; `updates` counts optimizer updates. `params` are the
    trainable parameters; buffers (BatchNorm running statistics) are not
    among them and travel in the model's state_dict.

    grid (parallel/mesh.py Grid spanning a process group, or None): the
    step's collectives; shards (parallel/tp.py Shards, tensor parallelism):
    the optimizer's slices, which `build_optimizer` must have been given
    in place of the whole ruled parameters (Shards.opt_params). The
    state_dict holds whole parameters, moments and the ranks' mean
    accumulator, the file one process writes; with a grid every rank calls
    state_dict and load_state_dict (they are collective)."""

    def __init__(self, model, optimizer, scheduler, grad_clip=5.0,
                 accum_grad=1, frontend=None, grid=None, shards=None):
        self.model = model
        self.frontend = frontend
        self.optimizer = optimizer
        self.scheduler = scheduler
        self.grad_clip = grad_clip
        self.accum_grad = max(int(accum_grad or 1), 1)
        self.params = [p for p in model.parameters() if p.requires_grad]
        self.grid = grid if grid is not None and grid.distributed else None
        self.shards = shards if shards is not None and shards.slices \
            else None
        self.step = 0
        self.updates = 0
        self.mini_step = 0
        self.acc = None

    def state_dict(self):
        opt = self.optimizer.state_dict()
        if self.shards is not None:
            opt = tpmod.gather_opt_state(opt, self.shards)
        acc = self.acc
        if acc is not None and self.grid is not None:
            acc = _unflat(mesh.all_reduce(_flat(acc)) / self.grid.world,
                          acc)
        return {"model": self.model.state_dict(),
                "optimizer": opt,
                "scheduler": self.scheduler.state_dict(),
                "step": self.step, "updates": self.updates,
                "mini_step": self.mini_step,
                "acc": None if acc is None else
                [a.detach().cpu() for a in acc]}

    def load_state_dict(self, state):
        self.model.load_state_dict(state["model"])
        opt = state["optimizer"]
        if self.shards is not None:
            self.shards.reset()
            opt = tpmod.shard_opt_state(opt, self.shards)
        self.optimizer.load_state_dict(opt)
        self.scheduler.load_state_dict(state["scheduler"])
        self.step, self.updates = int(state["step"]), int(state["updates"])
        self.mini_step = int(state.get("mini_step", 0))
        acc = state.get("acc")
        self.acc = None if acc is None else [
            a.to(p.device) for a, p in zip(acc, self.params)]


def _flat(tensors):
    return torch.cat([t.reshape(-1) for t in tensors])


def _unflat(flat, like):
    out, i = [], 0
    for t in like:
        out.append(flat[i:i + t.numel()].view_as(t))
        i += t.numel()
    return out


def pad_to_common_length(batch, grid):
    """Pad the batch's inputs along time (frames, or samples for a
    frontend) with zeros to the longest of every rank's (all-reduce of the
    max) → batch."""
    x = batch["inputs"]
    n = torch.tensor([x.shape[1]], dtype=torch.int64, device=x.device)
    T = int(mesh.all_reduce(n, op=torch.distributed.ReduceOp.MAX)[0])
    if T > x.shape[1]:
        pad = x.new_zeros((x.shape[0], T - x.shape[1]) + tuple(x.shape[2:]))
        batch = dict(batch, inputs=torch.cat([x, pad], dim=1))
    return batch


def train_step(state, batch, seed):
    """One micro-step on a batch of device tensors (batch_to) →
    metrics {loss, loss_att, loss_ctc, acc_att: floats, finite: bool}."""
    model = state.model
    dev = batch["inputs"].device
    if state.grid is not None:
        batch = pad_to_common_length(batch, state.grid)
    gen, chunk_gen = step_generators(seed, state.step, dev)
    model.train()
    for p in state.params:
        p.grad = None
    inputs, input_lens = model_inputs(
        batch, state.frontend,
        None if state.frontend is None
        else frontend_generator(seed, state.step, dev), train=True)
    with mesh.step_grid(state.grid):
        out = model(inputs, input_lens, batch["labels"],
                    batch["label_lens"], generator=gen,
                    chunk_generator=chunk_gen)
        out["loss"].backward()
    keys = sorted(out)
    vals = torch.stack([out[k].detach().float() for k in keys]
                       + [torch.isfinite(out["loss"].detach()).float()])
    if state.grid is not None:
        # the global mean of each loss and the count of finite ranks
        vals = mesh.all_reduce(vals)
        vals[:-1] /= state.grid.world
        finite = int(vals[-1]) == state.grid.world
    else:
        finite = bool(vals[-1])
    metrics = dict(zip(keys, vals[:-1].tolist()))
    metrics["finite"] = finite
    accumulate(state, [p.grad for p in state.params], finite)
    return metrics


def accumulate(state, grads, finite):
    """Fold one micro-step's grads (None = zero) into the running mean; at
    the accum_grad-th micro-step apply the update. A non-finite micro-step
    contributes zero grads and, at a boundary, keeps the parameters."""
    grads = [g if g is not None and finite else torch.zeros_like(p)
             for g, p in zip(grads, state.params)]
    n = state.mini_step
    if n == 0:
        state.acc = [g.detach().clone() for g in grads]
    else:
        for a, g in zip(state.acc, grads):
            a.add_((g - a) / (n + 1))
    state.mini_step += 1
    if state.mini_step == state.accum_grad:
        if state.grid is not None:
            # the ranks' mean, once an update
            state.acc = _unflat(mesh.all_reduce(_flat(state.acc))
                                / state.grid.world, state.acc)
        _apply_update(state, finite, state.shards)
        state.mini_step, state.acc = 0, None
    state.step += 1


def _apply_update(state, finite, shards=None):
    """Clip the averaged grads by their global norm, step the optimizer (on
    the slices of `shards` under tensor parallelism, then gather the whole
    parameters) and the schedule; a non-finite last micro-step keeps the
    parameters."""
    keep = None if finite else [p.detach().clone() for p in state.params]
    for p, a in zip(state.params, state.acc):
        p.grad = a
    if state.grad_clip:
        torch.nn.utils.clip_grad_norm_(state.params, state.grad_clip)
    if shards is not None:
        shards.take_grads()
    state.optimizer.step()
    state.scheduler.step()
    state.updates += 1
    if keep is not None:
        with torch.no_grad():
            for p, k in zip(state.params, keep):
                p.copy_(k)
        if shards is not None:
            shards.reset()
    elif shards is not None:
        shards.gather()
    for p in state.params:
        p.grad = None
    if shards is not None:
        for s in shards.slices.values():
            s.grad = None


@torch.no_grad()
def eval_step(model, batch, frontend=None):
    """→ (loss float, CTC probs (B, T', V) on the device, lens (B,)). The
    loss draws its dynamic chunk from a generator seeded 0, as masr_tpu's
    eval step uses PRNGKey(0); the probs are full context."""
    model.eval()
    chunk_gen = torch.Generator()
    chunk_gen.manual_seed(0)
    inputs, input_lens = model_inputs(batch, frontend)
    out = model(inputs, input_lens, batch["labels"], batch["label_lens"],
                chunk_generator=chunk_gen)
    probs, lens = model.get_encoder_out(inputs, input_lens)
    return float(out["loss"]), probs, lens


@torch.no_grad()
def eval_step_rescoring(model, batch, frontend=None):
    """eval_step that also returns the encoder rows, so that attention
    rescoring reuses the same encode (masr_tpu/training/train_state.py:120
    make_eval_step_rescoring) → (loss, encoder_out, probs, lens)."""
    model.eval()
    chunk_gen = torch.Generator()
    chunk_gen.manual_seed(0)
    inputs, input_lens = model_inputs(batch, frontend)
    out = model(inputs, input_lens, batch["labels"], batch["label_lens"],
                chunk_generator=chunk_gen)
    enc, probs, lens = model.encode_for_rescoring(inputs, input_lens)
    return float(out["loss"]), enc, probs, lens
