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

With a frontend (ops/specaug.py make_device_frontend, the trainer's
dataset_conf.on_device_frontend) the batch's inputs are int16-scale
waveforms and their lengths samples: the train step runs the frontend in
training mode on the device before the model, the eval steps its
deterministic fbank (masr_tpu/training/train_state.py:52-56, :102-110).
"""
import torch

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
    among them and travel in the model's state_dict."""

    def __init__(self, model, optimizer, scheduler, grad_clip=5.0,
                 accum_grad=1, frontend=None):
        self.model = model
        self.frontend = frontend
        self.optimizer = optimizer
        self.scheduler = scheduler
        self.grad_clip = grad_clip
        self.accum_grad = max(int(accum_grad or 1), 1)
        self.params = [p for p in model.parameters() if p.requires_grad]
        self.step = 0
        self.updates = 0
        self.mini_step = 0
        self.acc = None

    def state_dict(self):
        return {"model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict(),
                "scheduler": self.scheduler.state_dict(),
                "step": self.step, "updates": self.updates,
                "mini_step": self.mini_step,
                "acc": None if self.acc is None else
                [a.detach().cpu() for a in self.acc]}

    def load_state_dict(self, state):
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.scheduler.load_state_dict(state["scheduler"])
        self.step, self.updates = int(state["step"]), int(state["updates"])
        self.mini_step = int(state.get("mini_step", 0))
        acc = state.get("acc")
        self.acc = None if acc is None else [
            a.to(p.device) for a, p in zip(acc, self.params)]


def train_step(state, batch, seed):
    """One micro-step on a batch of device tensors (batch_to) →
    metrics {loss, loss_att, loss_ctc, acc_att: floats, finite: bool}."""
    model = state.model
    dev = batch["inputs"].device
    gen, chunk_gen = step_generators(seed, state.step, dev)
    model.train()
    for p in state.params:
        p.grad = None
    inputs, input_lens = model_inputs(
        batch, state.frontend,
        None if state.frontend is None
        else frontend_generator(seed, state.step, dev), train=True)
    out = model(inputs, input_lens, batch["labels"], batch["label_lens"],
                generator=gen, chunk_generator=chunk_gen)
    out["loss"].backward()
    metrics = {k: float(v.detach()) for k, v in out.items()}
    finite = bool(torch.isfinite(out["loss"]))
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
        _apply_update(state, finite)
        state.mini_step, state.acc = 0, None
    state.step += 1


def _apply_update(state, finite):
    """Clip the averaged grads by their global norm, step the optimizer and
    the schedule; a non-finite last micro-step keeps the parameters."""
    keep = None if finite else [p.detach().clone() for p in state.params]
    for p, a in zip(state.params, state.acc):
        p.grad = a
    if state.grad_clip:
        torch.nn.utils.clip_grad_norm_(state.params, state.grad_clip)
    state.optimizer.step()
    state.scheduler.step()
    state.updates += 1
    if keep is not None:
        with torch.no_grad():
            for p, k in zip(state.params, keep):
                p.copy_(k)
    for p in state.params:
        p.grad = None


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
