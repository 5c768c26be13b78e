"""Probe the first training step's card-vs-CPU gap (chip_smoke's
first_step_card_vs_cpu) by loss branch, over fresh training batches.

    python3 -m masr_tpu_torch.bench.first_step_probe [--family F] [--batches N]

Run from the repository root: it takes chip_smoke.py's corpus (phase 12's
synthetic speech, written under build/smoke/first_step_probe/) and its
training config of the family (`efficient_conformer` or `conformer`) at
dropout 0. One model on the card and one on the CPU, from the same init;
for each of N batches of the training loader (its features dithered, so
each batch differs) the grads of the config's hybrid loss, of the CTC loss
alone (ctc_weight 1) and of the attention loss alone (ctc_weight 0) are
taken on both, and for each the largest card-vs-CPU error over a sample of
encoder parameters, relative to the CPU grad's largest magnitude (the
metric of first_step_card_vs_cpu). Beside them, the number of the
decoder's FFN units whose pre-activation has another sign on the card
than on the CPU: the attention loss reaches every encoder grad through
that ReLU's derivative. One JSON line per batch, then a summary with the
card's name and power limit.
"""
import argparse
import json
import os
import sys

import torch

ENCODER_SAMPLE = ("encoder.embed.out.0.weight",
                  "encoder.encoders.3.conv_module.depthwise_conv.weight",
                  "encoder.encoders.7.self_attn.linear_q.weight",
                  "encoder.encoders.11.norm_final.weight")


def _grads(trainer, batch, ctc_weight, acts=None):
    """(grads by name, decoder FFN pre-activations by module name) of one
    step of `trainer`'s model on `batch` with the loss at ctc_weight."""
    from masr_tpu_torch.training.train_state import batch_to, step_generators
    model = trainer.model
    model.ctc_weight = ctc_weight
    b = batch_to(batch, trainer.device)
    gen, chunk = step_generators(0, 0, trainer.device)
    for p in model.parameters():
        p.grad = None
    hooks = [] if acts is None else [
        mod.register_forward_hook(
            lambda m, i, o, n=n: acts.__setitem__(n, o.detach().cpu()))
        for n, mod in model.decoder.named_modules()
        if n.endswith("feed_forward.w_1")]
    out = model.train()(b["inputs"], b["input_lens"], b["labels"],
                        b["label_lens"], generator=gen, chunk_generator=chunk)
    for h in hooks:
        h.remove()
    out["loss"].backward()
    return {n: p.grad.detach().double().cpu()
            for n, p in model.named_parameters() if p.grad is not None}


def _gap(card, cpu):
    return max(float((card[n] - cpu[n]).abs().max() / cpu[n].abs().max())
               for n in ENCODER_SAMPLE)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--family", default="efficient_conformer",
                    choices=("efficient_conformer", "conformer"))
    ap.add_argument("--batches", type=int, default=8)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from masr_tpu_torch.ops.cuda import build
    from masr_tpu_torch.training.trainer import MASRTrainer
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.build(["conformer_layer_train", "ctc_loss"])
    root = os.path.join(cs.WORK, "first_step_probe")
    corpus = cs.write_train_corpus(os.path.join(root, "corpus"),
                                   cs.train_vocab())
    config = cs.eff_train_config if args.family == "efficient_conformer" \
        else cs.train_config
    conf = config(corpus, root, 1, dropout=False)
    trainers = {}
    for name in ("card", "cpu"):
        t = MASRTrainer(conf, device="cuda" if name == "card" else "cpu")
        ds, _, loader = t._setup_dataloader(True)
        t._setup_model(ds.feature_dim, ds.vocab_size)
        trainers[name] = t
    hybrid_w = float(conf["model_conf"]["ctc_weight"])
    rows = []
    for k in range(args.batches):
        batch = next(iter(loader))
        acts = {"card": {}, "cpu": {}}
        row = {"batch": k}
        for branch, w in (("hybrid", hybrid_w), ("ctc_only", 1.0),
                          ("attention_only", 0.0)):
            g = {name: _grads(t, batch, w, acts[name] if branch == "hybrid"
                              else None) for name, t in trainers.items()}
            row[branch] = _gap(g["card"], g["cpu"])
        row["decoder_relu_flips"] = sum(
            int(((acts["card"][n] > 0) != (acts["cpu"][n] > 0)).sum())
            for n in acts["cpu"])
        rows.append(row)
        print(json.dumps(row), flush=True)
    print(json.dumps({
        "family": args.family, "card": cs.card(), "batches": len(rows),
        "sample": list(ENCODER_SAMPLE),
        **{f"{b}_max": max(r[b] for r in rows)
           for b in ("hybrid", "ctc_only", "attention_only")},
        "batches_with_flips": sum(r["decoder_relu_flips"] > 0
                                  for r in rows)}), flush=True)


if __name__ == "__main__":
    main()
