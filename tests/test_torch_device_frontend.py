"""The port's on-device frontend (masr_tpu_torch/ops/specaug.py), its host
half (data/collate.py collate_waveforms) and optimizer_conf.fused
(optimizer/schedulers.py build_optimizer) against masr_tpu's on the CPU.

- apply_specaug and apply_specsub are fed masr_tpu's own draws, remade from
  its JAX key with the splits of masr_tpu/ops/specaug.py: the results equal
  specaug_jax and specsub_jax exactly. The features are multiples of 1/64
  within ±8, so the mean fill's f32 sum is exact in any order.
- draw_specaug and draw_specsub: ranges and distributions, and the
  behaviour tests/test_specaug_device.py pins on masr_tpu's (masks cover
  regions, mean fill, one code path for every draw, sources earlier
  original frames, frames past a length untouched, width-1 spans).
- the batched fbank at dither 0 against fbank_jax: atol 1e-3 on the log
  mel energies (f32 FFTs in other orders), frame counts equal.
- collate_waveforms == masr_tpu's for the same rng.
- the fused Adam and AdamW (torch's fused ones, after the train step's
  clip_grad_norm_), with and without clipping: three updates against
  masr_tpu's fused_adam, whose clip scale is clip / max(norm, clip) where
  clip_grad_norm_ divides by norm + 1e-6 (rtol 2e-6, atol 2e-7, as
  tests/test_fused_optimizer.py holds it to optax), and against the
  port's unfused optimizer (same tolerances).
- a tiny CPU trainer with on_device_frontend, the fused Adam and a binary
  manifest: the loss falls.
"""
import os
from types import SimpleNamespace

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from masr_tpu.ops.specaug import specaug_jax, specsub_jax
from masr_tpu_torch.ops.specaug import (apply_specaug, apply_specsub,
                                        draw_specaug, draw_specsub,
                                        make_device_frontend, specaug,
                                        specsub)
from test_torch_threads import one_torch_thread  # noqa: F401


def _feats(B=3, T=50, F=12, seed=0):
    """Features on a 1/64 grid within ±8 (every f32 sum of them exact)."""
    rs = np.random.RandomState(seed)
    return np.round(rs.uniform(-8, 8, (B, T, F)) * 64).astype(
        np.float32) / 64


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _jax_specaug_draws(rng, B, F, lens, nf, nt, max_f, max_t):
    """masr_tpu's draws inside specaug_jax (ops/specaug.py:17-54)."""
    r1, r2 = jax.random.split(rng)
    out = {}
    for key, r, n, mx, limit in (("f", r1, nf, max_f, F),
                                 ("t", r2, nt, max_t, lens[:, None])):
        rngs = jax.random.split(r, 2)
        w = jax.random.randint(rngs[0], (B, n), 0, mx + 1)
        s = (jax.random.uniform(rngs[1], (B, n))
             * jnp.maximum(limit - w, 1)).astype(jnp.int32)
        out[key + "_widths"] = torch.from_numpy(np.asarray(w, np.int64))
        out[key + "_starts"] = torch.from_numpy(np.asarray(s, np.int64))
    return out


@pytest.mark.parametrize("zero", [False, True], ids=["mean", "zero"])
@pytest.mark.parametrize("key", [0, 7, 31])
def test_apply_specaug_equals_specaug_jax(key, zero):
    """apply_specaug on masr_tpu's draws == specaug_jax, bit for bit."""
    x = _feats(seed=key)
    lens = np.asarray([50, 37, 12])
    rng = jax.random.PRNGKey(key)
    want = specaug_jax(jnp.asarray(x), jnp.asarray(lens), rng,
                       n_freq_masks=2, n_time_masks=3, max_f=5, max_t=9,
                       replace_with_zero=zero)
    draws = _jax_specaug_draws(rng, 3, 12, jnp.asarray(lens), 2, 3, 5, 9)
    got = apply_specaug(torch.from_numpy(x), torch.from_numpy(lens), draws,
                        replace_with_zero=zero)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.numpy() != x).any()


@pytest.mark.parametrize("key", [0, 3, 11])
def test_apply_specsub_equals_specsub_jax(key):
    """apply_specsub on masr_tpu's draws (specsub_jax's key splits) ==
    specsub_jax, bit for bit."""
    x = _feats(T=60, seed=key)
    lens = np.asarray([60, 41, 9])
    rng = jax.random.PRNGKey(key)
    want = specsub_jax(jnp.asarray(x), jnp.asarray(lens), rng, max_t=12,
                       num_t_sub=3)
    draws = {"t": [], "start": [], "pos": []}
    r = rng
    jl = jnp.asarray(lens)
    for _ in range(3):
        r, r1, r2, r3 = jax.random.split(r, 4)
        t = jax.random.randint(r1, (3,), 1, 13)
        start = jax.random.randint(r2, (3,), 0, jnp.maximum(jl, 1))
        pos = jax.random.randint(r3, (3,), 0, start + 1)
        for k, v in (("t", t), ("start", start), ("pos", pos)):
            draws[k].append(np.asarray(v, np.int64))
    draws = {k: torch.from_numpy(np.stack(v)) for k, v in draws.items()}
    got = apply_specsub(torch.from_numpy(x), torch.from_numpy(lens), draws)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.numpy() != x).any()


def test_draw_specaug_ranges_and_distribution():
    """Widths uniform over [0, max] (every value drawn, none beyond),
    starts within [0, max(limit − width, 1)), so a mask never leaves the
    valid frames when it fits; the same generator seed draws the same."""
    x = torch.zeros(64, 40, 20)
    lens = torch.tensor([40, 25, 7, 1] * 16)
    d = draw_specaug(_gen(0), x, lens, 2, 2, 6, 8)
    for key, mx in (("f", 6), ("t", 8)):
        w, s = d[key + "_widths"], d[key + "_starts"]
        assert w.shape == s.shape == (64, 2)
        counts = torch.bincount(w.flatten(), minlength=mx + 1)
        assert len(counts) == mx + 1 and (counts > 0).all()
        limit = torch.full((64, 1), 20) if key == "f" else lens[:, None]
        assert (s >= 0).all() and (s < torch.clamp(limit - w, min=1)).all()
        fits = w <= limit
        assert ((s + w <= limit) | ~fits).all()
    again = draw_specaug(_gen(0), x, lens, 2, 2, 6, 8)
    assert all(torch.equal(d[k], again[k]) for k in d)
    other = draw_specaug(_gen(1), x, lens, 2, 2, 6, 8)
    assert any(not torch.equal(d[k], other[k]) for k in d)


def test_draw_specsub_ranges_and_distribution():
    """Span lengths over [1, max_t] (never 0, max reached), starts over
    [0, max(len, 1)), positions back over [0, start]."""
    lens = torch.tensor([60, 41, 9, 1] * 32)
    d = draw_specsub(_gen(2), lens, max_t=5, num_t_sub=3)
    assert d["t"].shape == d["start"].shape == d["pos"].shape == (3, 128)
    assert d["t"].min() == 1 and d["t"].max() == 5
    assert (d["start"] >= 0).all() and \
        (d["start"] < torch.clamp(lens, min=1)).all()
    assert (d["pos"] >= 0).all() and (d["pos"] <= d["start"]).all()
    assert (d["pos"] == d["start"]).any() and (d["pos"] == 0).any()


def test_specaug_masks_regions_with_mean_fill():
    """Masked cells take the utterance's mean over its valid frames, the
    rest keep their values; zero fill gives 0."""
    x = torch.from_numpy(_feats(B=2, T=40, F=16, seed=5)) + 3.0
    lens = torch.tensor([40, 30])
    y = specaug(x, lens, _gen(4), n_freq_masks=2, n_time_masks=2, max_f=6,
                max_t=10)
    changed = y != x
    assert changed.any()
    for b, n in enumerate(lens.tolist()):
        mean = x[b, :n].mean()
        assert torch.allclose(y[b][changed[b]],
                              mean.expand(int(changed[b].sum())))
    z = specaug(x, lens, _gen(4), n_freq_masks=2, n_time_masks=2, max_f=6,
                max_t=10, replace_with_zero=True)
    assert torch.equal(z != x, changed) and (z[changed] == 0).all()


def test_specaug_one_code_path_many_draws():
    """Other generator seeds mask other regions through the same call."""
    x = torch.ones(2, 30, 12)
    lens = torch.tensor([30, 30])
    masks = {tuple((specaug(x, lens, _gen(s), max_f=5, max_t=8,
                            replace_with_zero=True) == 0).flatten().tolist())
             for s in range(6)}
    assert len(masks) > 3


def test_specsub_sources_are_earlier_original_frames():
    """Every frame is an original frame at or before its position; frames
    at or past a length are never targets; width-1 spans still change."""
    B, T, F = 4, 60, 3
    x = (torch.arange(B * T, dtype=torch.float32).reshape(B, T, 1)
         .expand(B, T, F).contiguous())
    lens = torch.tensor([60, 50, 41, 60])
    y = specsub(x, lens, _gen(3), max_t=20, num_t_sub=3)
    src = (y[:, :, 0] - torch.arange(B)[:, None] * T).round().long()
    assert (src <= torch.arange(T)[None]).all() and (src >= 0).all()
    assert (src != torch.arange(T)[None]).any()
    for b, n in enumerate(lens.tolist()):
        assert torch.equal(src[b, n:], torch.arange(n, T))
    assert any(not torch.equal(specsub(x, lens, _gen(k), max_t=1,
                                       num_t_sub=4), x) for k in range(8))


def test_frontend_train_draws_eval_is_deterministic():
    """make_device_frontend: in training, fbank with dither and the masks
    (SpecSub when its conf is given) differ between generators; in eval,
    fbank at dither 0, the same for any generator, equal to fbank_torch."""
    from masr_tpu_torch.ops.fbank import fbank_torch
    pre = {"feature_method": "fbank", "n_mels": 20, "sample_rate": 16000}
    rs = np.random.RandomState(2)
    wav = torch.from_numpy((rs.standard_normal((2, 16000)) * 3000).astype(
        np.float32))
    lens = torch.tensor([16000, 12000])
    none = {"F": 0, "T": 0, "n_freq_masks": 0, "n_time_masks": 0}
    plain = make_device_frontend(pre, none)
    sub = make_device_frontend(pre, none, {"max_t": 15, "num_t_sub": 3})
    f_plain, l1 = plain(wav, lens, _gen(0), True)
    f_sub, l2 = sub(wav, lens, _gen(0), True)
    assert torch.equal(l1, l2) and l1.dtype == torch.int64
    assert l1.tolist() == [98, 73] and not torch.equal(f_plain, f_sub)
    e1, _ = sub(wav, lens, _gen(0), False)
    e2, _ = sub(wav, lens, None, False)
    want, _ = fbank_torch(wav, lens, num_mel_bins=20)
    assert torch.equal(e1, e2) and torch.equal(e1, want)
    with pytest.raises(ValueError, match="fbank"):
        make_device_frontend({"feature_method": "linear"})


def test_batched_fbank_matches_fbank_jax():
    """fbank_torch over a ragged int16-scale batch at dither 0 ==
    masr_tpu's fbank_jax: frame counts equal, log mel energies within
    1e-3, frames past a length 0 in both."""
    from masr_tpu.ops.fbank import fbank_jax
    from masr_tpu_torch.ops.fbank import fbank_torch
    rs = np.random.RandomState(3)
    wav = np.round(rs.standard_normal((3, 12000)) * 2000).astype(np.float32)
    lens = np.asarray([12000, 8000, 400])
    want, want_l = fbank_jax(jnp.asarray(wav), jnp.asarray(lens),
                             num_mel_bins=80)
    got, got_l = fbank_torch(torch.from_numpy(wav), torch.from_numpy(lens),
                             num_mel_bins=80)
    assert got_l.tolist() == np.asarray(want_l).tolist() == [73, 48, 1]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3,
                               rtol=0)
    assert (got[2, 1:] == 0).all()


def test_collate_waveforms_matches_masr_tpu():
    """collate_waveforms == masr_tpu's, key for key, for the same rng."""
    from masr_tpu.data.collate import collate_waveforms as jcollate
    from masr_tpu_torch.data.collate import collate_waveforms
    rs = np.random.RandomState(4)
    items = [(rs.standard_normal(n).astype(np.float32),
              rs.randint(2, 9, k).astype(np.int32))
             for n, k in ((17000, 3), (5000, 9), (16000, 1), (33, 4))]
    for bucket in (16000, 1):
        got = collate_waveforms(items, sample_bucket=bucket,
                                rng=np.random.RandomState(5))
        want = jcollate(items, sample_bucket=bucket,
                        rng=np.random.RandomState(5))
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["inputs"].shape == (4, 17000)


# --------------------------------------------------------------------------- #
# the fused Adam
# --------------------------------------------------------------------------- #
def _shapes():
    return {"kernel": (64, 128), "bias": (128,), "scale": (7,)}


def _params(seed=0):
    rs = np.random.RandomState(seed)
    return {k: rs.standard_normal(s).astype(np.float32)
            for k, s in _shapes().items()}


def _grads(step):
    rs = np.random.RandomState(100 + step)
    return {k: (rs.standard_normal(s) * 3.0).astype(np.float32)
            for k, s in _shapes().items()}


def _run_port(optimizer, fused, clip, wd, n=3):
    """n updates through build_optimizer (masr_tpu's warmup schedule) and
    the train step's update (training/train_state.py _apply_update: the
    clip, the optimizer, the schedule)."""
    from masr_tpu_torch.optimizer.schedulers import build_optimizer
    from masr_tpu_torch.training.train_state import _apply_update
    params = {k: torch.nn.Parameter(torch.from_numpy(v))
              for k, v in _params().items()}
    opt, sched, _ = build_optimizer(params.values(), dict(
        optimizer=optimizer, learning_rate=1e-3, weight_decay=wd,
        fused=fused, scheduler="WarmupLR", scheduler_conf=dict(
            warmup_steps=3)))
    state = SimpleNamespace(params=list(params.values()), optimizer=opt,
                            scheduler=sched, grad_clip=clip, updates=0)
    outs = []
    for i in range(n):
        grads = _grads(i)
        state.acc = [torch.from_numpy(grads[k]) for k in params]
        _apply_update(state, True)
        outs.append({k: p.detach().numpy().copy()
                     for k, p in params.items()})
    return outs


@pytest.mark.parametrize("clip", [None, 0.5], ids=["noclip", "clip"])
@pytest.mark.parametrize("decoupled", [False, True], ids=["adam", "adamw"])
def test_fused_adam_matches_masr_tpu_and_unfused(decoupled, clip):
    """Three updates of the port's optimizer_conf.fused Adam / AdamW ==
    masr_tpu's fused_adam (optax) and == the port's unfused Adam / AdamW,
    weight decay 1e-2, masr_tpu's warmup schedule."""
    from masr_tpu.optimizer.fused import fused_adam
    from masr_tpu.optimizer.schedulers import warmup_lr as jwarmup
    wd = 1e-2
    tx = fused_adam(jwarmup(1e-3, warmup_steps=3), weight_decay=wd,
                    decoupled=decoupled, grad_clip=clip)
    p = {k: jnp.asarray(v) for k, v in _params().items()}
    state = tx.init(p)
    want = []
    for i in range(3):
        g = {k: jnp.asarray(v) for k, v in _grads(i).items()}
        upd, state = tx.update(g, state, p)
        p = optax.apply_updates(p, upd)
        want.append({k: np.asarray(v) for k, v in p.items()})
    name = "AdamW" if decoupled else "Adam"
    fused = _run_port(name, True, clip, wd)
    unfused = _run_port(name, False, clip, wd)
    for w, f, u in zip(want, fused, unfused):
        for k in w:
            np.testing.assert_allclose(f[k], w[k], rtol=2e-6, atol=2e-7)
            np.testing.assert_allclose(f[k], u[k], rtol=2e-6, atol=2e-7)
    assert not np.allclose(fused[-1]["kernel"], _params()["kernel"])


def test_build_optimizer_routes_fused():
    """optimizer_conf.fused builds torch's fused Adam and AdamW (their
    weight decay L2 and decoupled); unfused, they keep torch's default
    (fused None, so the multi-tensor route on the card); SGD ignores it;
    the state_dict round-trips."""
    from masr_tpu_torch.optimizer.schedulers import build_optimizer
    p = [torch.nn.Parameter(torch.ones(3))]
    for name, cls in (("Adam", torch.optim.Adam),
                      ("AdamW", torch.optim.AdamW)):
        opt, _, _ = build_optimizer(p, dict(optimizer=name, fused=True))
        assert type(opt) is cls and opt.defaults["fused"]
        plain, _, _ = build_optimizer(p, dict(optimizer=name))
        assert plain.defaults["fused"] is None \
            and plain.defaults["foreach"] is None
    p[0].grad = torch.ones(3)
    opt.step()
    again, _, _ = build_optimizer(p, dict(optimizer="AdamW", fused=True))
    again.load_state_dict(opt.state_dict())
    assert int(again.state[p[0]]["step"]) == 1
    sgd, _, _ = build_optimizer(p, dict(optimizer="SGD", fused=True))
    assert isinstance(sgd, torch.optim.SGD)


# --------------------------------------------------------------------------- #
# the trainer
# --------------------------------------------------------------------------- #
def test_trainer_with_device_frontend_fused_adam_binary_manifest(tmp_path):
    """MASRTrainer(device="cpu") with dataset_conf.on_device_frontend, the
    fused Adam and a binary manifest, augmented by an augmentation JSON
    whose specaug and specsub params drive the frontend: batches are
    waveforms, every train step makes its features through the frontend
    in training mode and eval through the deterministic one, and the loss
    falls over 3 epochs of 4 steps."""
    from masr_tpu_torch.data.binary import create_manifest_binary
    from masr_tpu_torch.training import train_state as ts
    from masr_tpu_torch.training.trainer import MASRTrainer
    from test_torch_training import _corpus, _trainer_config
    import json
    corpus = _corpus(str(tmp_path / "corpus"))
    create_manifest_binary(corpus["train"], corpus["test"])
    conf = _trainer_config(corpus, str(tmp_path), 3)
    conf["dataset_conf"] = dict(conf["dataset_conf"], manifest_type="binary",
                                on_device_frontend=True, sample_bucket=4000)
    conf["optimizer_conf"] = dict(conf["optimizer_conf"], fused=True)
    aug = tmp_path / "aug.json"
    aug.write_text(json.dumps([
        {"type": "volume", "params": {"min_gain_dBFS": -3,
                                      "max_gain_dBFS": 3}, "prob": 1.0},
        {"type": "specaug", "params": {"F": 4, "T": 5, "n_freq_masks": 1,
                                       "n_time_masks": 1}, "prob": 1.0},
        {"type": "specsub", "params": {"max_t": 3, "num_t_sub": 1},
         "prob": 1.0}]))
    seen, orig = [], ts.model_inputs

    def spy(batch, frontend=None, generator=None, train=False):
        seen.append((batch["inputs"].dim(), frontend is not None, train))
        return orig(batch, frontend, generator, train)

    ts.model_inputs = spy
    try:
        tr = MASRTrainer(conf, device="cpu")
        tr.train(save_model_path=str(tmp_path / "models"),
                 augment_conf_path=str(aug))
    finally:
        ts.model_inputs = orig
    assert tr.state.step == 12
    assert (2, True, True) in seen and (2, True, False) in seen
    assert all(d == 2 and f for d, f, _ in seen)
    with open(os.path.join(str(tmp_path), "log", "scalars.jsonl")) as f:
        points = [json.loads(l) for l in f]
    losses = [p["value"] for p in points if p["tag"] == "Train/Loss"]
    assert len(losses) == 12 and np.isfinite(losses).all()
    assert np.mean(losses[-4:]) < losses[0]
