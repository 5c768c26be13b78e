"""The rank processes of the port's parallel tests
(tests/test_torch_parallel.py, tests/test_torch_tensor_parallel.py). It
imports torch and masr_tpu_torch only, and holds no test.

    RANK=r WORLD_SIZE=n python tests/test_torch_parallel_worker.py SPEC OUT

SPEC is a torch.save'd dict {"store": a file:// rendezvous path,
"jobs": [(name, kwargs)]}; each rank joins the gloo group through
parallel/mesh.py maybe_init_distributed, runs the jobs in order (every
rank the same jobs: they are collective) and writes {name: result} to
OUT.<rank>. `launch` starts the ranks from a test and waits for them.
"""
import os
import subprocess
import sys

import numpy as np
import torch


def launch(tmp_path, world, jobs, timeout=240):
    """Run `jobs` on `world` gloo ranks (one torch thread each, a file://
    rendezvous under tmp_path) → [the rank's results] in rank order.
    A rank that fails or outlives `timeout` seconds fails the call."""
    spec = os.path.join(str(tmp_path), f"spec_{world}.pt")
    out = os.path.join(str(tmp_path), f"out_{world}")
    torch.save({"store": os.path.join(str(tmp_path), f"store_{world}"),
                "jobs": jobs}, spec)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, WORLD_SIZE=str(world), OMP_NUM_THREADS="1",
               MKL_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
                   [root] + [p for p in os.environ.get(
                       "PYTHONPATH", "").split(os.pathsep) if p]))
    env.pop("MASTER_ADDR", None)
    procs = []
    for r in range(world):
        procs.append(subprocess.Popen(
            [sys.executable, __file__, spec, out],
            env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0].decode(
                errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r} failed:\n{logs[r][-4000:]}"
    return [torch.load(f"{out}.{r}", weights_only=False)
            for r in range(world)]


def build(kind, conf, state_dict):
    """The port's model `kind` from build_model kwargs `conf` (with feat,
    vocab and, True, no_pos_dropout: the Squeezeformer subsampling's
    positional dropout, which it keeps at 0.1 whatever the config, off),
    loaded with `state_dict` (BatchNorm counters may be absent)."""
    from masr_tpu_torch.models.cmvn import GlobalCMVN
    from masr_tpu_torch.models.registry import build_model
    conf = dict(conf)
    feat, vocab = conf.pop("feat"), conf.pop("vocab")
    no_pos_dropout = conf.pop("no_pos_dropout", False)
    model = build_model(kind, feat, vocab,
                        cmvn=GlobalCMVN(np.zeros(feat), np.ones(feat)),
                        **conf)
    if no_pos_dropout:
        model.encoder.embed.pos_enc.dropout_rate = 0.0
    model.load_state_dict(state_dict, strict=False)
    return model


def steps(kind, conf, state_dict, opt_conf, batches, tp=1, grad_clip=5.0,
          accum_grad=1, seed=0, nan=None, trim=False):
    """Train steps of the port over the grid of `tp`: each global batch in
    `batches` (dicts of numpy arrays) split by shard_batch, one train_step
    each; nan = (step, rank): that rank's inputs are NaN at that step;
    trim: each rank's frames cut to its longest input_len. →
    {"metrics": [per step], "params": whole state_dict after, "moments":
    {name: shape of exp_avg} of the rank, "updates": optimizer updates,
    "params_per_step": [state_dict after each step]}."""
    from masr_tpu_torch.optimizer.schedulers import build_optimizer
    from masr_tpu_torch.parallel import mesh
    from masr_tpu_torch.parallel.tp import shard_params
    from masr_tpu_torch.training.train_state import (TrainState, batch_to,
                                                     train_step)
    grid = mesh.make_mesh_2d(tp)
    model = mesh.replicate(build(kind, conf, state_dict), grid)
    shards = shard_params(model, grid)
    opt, sched, _ = build_optimizer(shards.opt_params(), opt_conf)
    state = TrainState(model, opt, sched, grad_clip=grad_clip,
                       accum_grad=accum_grad, grid=grid, shards=shards)
    metrics, per_step = [], []
    for i, batch in enumerate(batches):
        rows = mesh.shard_batch(batch, grid.rank, grid.world)
        if nan is not None and nan == (i, grid.rank):
            rows = dict(rows, inputs=np.full_like(rows["inputs"], np.nan))
        if trim:
            rows = dict(rows, inputs=rows["inputs"][
                :, :max(int(rows["input_lens"].max()), 1)])
        metrics.append(train_step(state, batch_to(rows, "cpu"), seed))
        per_step.append({k: v.detach().clone()
                         for k, v in model.state_dict().items()})
    names = [n for n, _ in model.named_parameters()]
    moments = {names[i]: tuple(opt.state[p]["exp_avg"].shape)
               for i, p in enumerate(shards.opt_params())
               if "exp_avg" in opt.state.get(p, {})}
    return {"metrics": metrics, "params": per_step[-1],
            "params_per_step": per_step, "moments": moments,
            "updates": state.updates, "rank": grid.rank,
            "state_dict": state.state_dict()}


def grads(kind, conf, state_dict, batch, seed=0):
    """One forward and backward of the port on the rank's rows of `batch`
    (train mode), the grads averaged over the ranks → {"loss", "grads",
    "buffers"} (the BatchNorm running statistics after the step)."""
    from masr_tpu_torch.parallel import mesh
    from masr_tpu_torch.training.train_state import batch_to, \
        step_generators
    grid = mesh.make_mesh()
    model = build(kind, conf, state_dict).train()
    rows = batch_to(mesh.shard_batch(batch, grid.rank, grid.world), "cpu")
    gen, chunk = step_generators(seed, 0, "cpu")
    with mesh.step_grid(grid):
        out = model(rows["inputs"], rows["input_lens"], rows["labels"],
                    rows["label_lens"], generator=gen,
                    chunk_generator=chunk)
        out["loss"].backward()
    loss = out["loss"].detach()
    gs = {n: p.grad.detach().clone() for n, p in model.named_parameters()
          if p.grad is not None}
    if grid.distributed:
        loss = mesh.all_reduce(loss.clone()) / grid.world
        for g in gs.values():
            mesh.all_reduce(g).div_(grid.world)
    return {"loss": float(loss), "grads": gs,
            "buffers": {n: b.clone() for n, b in model.named_buffers()
                        if "running" in n}}


def seeds(layers, B, step_seed):
    """This rank's layer_seeds of B rows from a step generator seeded
    step_seed, after a draw whose size follows the rank's batch."""
    from masr_tpu_torch.ops.dropout_hash import layer_seeds
    from masr_tpu_torch.parallel import mesh
    g = torch.Generator().manual_seed(step_seed)
    torch.rand(B, 5, generator=g)
    with mesh.step_grid(mesh.make_mesh()):
        return layer_seeds(layers, B, g, "cpu")


def encoder_rows(kind, conf, state_dict, batch, seed=0):
    """The encoder's output of the rank's rows in train mode (dropout
    drawn from the step generator) → (out, lens)."""
    from masr_tpu_torch.parallel import mesh
    from masr_tpu_torch.training.train_state import batch_to, \
        step_generators
    grid = mesh.make_mesh()
    model = build(kind, conf, state_dict).train()
    rows = batch_to(mesh.shard_batch(batch, grid.rank, grid.world), "cpu")
    gen, chunk = step_generators(seed, 0, "cpu")
    with torch.no_grad(), mesh.step_grid(grid):
        out, masks = model.encoder.forward_train(
            rows["inputs"], rows["input_lens"], generator=gen,
            chunk_generator=chunk)
    return out, masks


def trainer(config, save_model_path):
    """MASRTrainer.train on this rank's shard → {"rank", "world"}."""
    from masr_tpu_torch.training.trainer import MASRTrainer
    tr = MASRTrainer(config, device="cpu")
    tr.train(save_model_path=save_model_path, augment_conf_path=None)
    return {"rank": tr.rank, "world": tr.world,
            "tp": tr.tensor_parallel, "step": tr.state.step}


JOBS = {"steps": steps, "grads": grads, "seeds": seeds,
        "encoder_rows": encoder_rows, "trainer": trainer}


def main(spec_path, out):
    torch.set_num_threads(1)
    from masr_tpu_torch.parallel import mesh
    spec = torch.load(spec_path, weights_only=False)
    rank, _ = mesh.maybe_init_distributed(
        "cpu", init_method="file://" + spec["store"])
    results = {}
    for name, kwargs in spec["jobs"]:
        results[name] = JOBS[kwargs.pop("job", name)](**kwargs)
    torch.distributed.barrier()
    torch.save(results, f"{out}.{rank}")
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
