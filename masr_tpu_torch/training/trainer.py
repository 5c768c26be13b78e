"""MASRTrainer: training and evaluation on one GPU (port of
masr_tpu/training/trainer.py: _setup_dataloader :153, _setup_model :225,
train :282, _evaluate_loader :477, evaluate :569).

Same config schema and checkpoint semantics as masr_tpu: per-epoch
checkpoints with last/best retention and auto-resume from last_model,
mid-epoch saves, JSONL scalars, an end-of-epoch ctc_greedy evaluation.
On the card the CTC loss runs the CTC kernel (forward and backward) and
every encoder layer of every step its family's training-layer kernel: the
Conformer's, or the Squeezeformer's with a layer_norm conv module; a
Squeezeformer with the BatchNorm default trains its eager layers, whose
running statistics travel in the model's state_dict (checkpoints, resume)
and are kept after a non-finite step, as in masr_tpu. Training is f32
(TF32 off).

Not ported (ROADMAP.md module item 7), each raising NotImplementedError:
host augmentation (an augmentation config with any prob > 0), the
on-device frontend, enable_amp, the fused Adam, binary manifests,
tensor-parallel training, eval decoders other than ctc_greedy; absent:
multi-host sampling, create_data, extract_features and export.
"""
import logging
import os
import time

import numpy as np
import torch

from masr_tpu_torch.data.dataset import MASRDataset, check_no_augmentation
from masr_tpu_torch.data.loader import DataLoader
from masr_tpu_torch.data.normalizer import FeatureNormalizer
from masr_tpu_torch.data.sampler import BatchShuffleSampler
from masr_tpu_torch.data.text_featurizer import TextFeaturizer
from masr_tpu_torch.decoders.greedy import greedy_decoder_batch
from masr_tpu_torch.infer.inference_model import resolve_device
from masr_tpu_torch.models.cmvn import GlobalCMVN
from masr_tpu_torch.models.registry import build_model
from masr_tpu_torch.models.weights import flax_like_init
from masr_tpu_torch.optimizer.schedulers import build_optimizer
from masr_tpu_torch.training import checkpoints as ckpt
from masr_tpu_torch.training.logging_util import ScalarWriter
from masr_tpu_torch.training.train_state import (TrainState, batch_to,
                                                 eval_step, train_step)
from masr_tpu_torch.utils.config import dict_to_object, load_config
from masr_tpu_torch.utils.metrics import cer, wer

logger = logging.getLogger("masr_tpu_torch")
if not logger.handlers:
    _h = logging.StreamHandler()
    _h.setFormatter(logging.Formatter("[%(asctime)s %(levelname)s] "
                                      "%(message)s", "%Y-%m-%d %H:%M:%S"))
    logger.addHandler(_h)
    logger.setLevel(logging.INFO)
    logger.propagate = False


def _not_ported(what):
    return NotImplementedError(f"{what} is not ported (ROADMAP.md module "
                               "item 7)")


class MASRTrainer(object):
    def __init__(self, configs, device="cuda", overwrites=None):
        """configs: a YAML path or a dict (masr_tpu's schema); device:
        "cuda" (the default; raises without a card) or "cpu"; overwrites:
        "a.b=value,..." (values parsed as YAML)."""
        if isinstance(configs, str):
            configs = load_config(configs)
        self.configs = dict_to_object(dict(configs))
        if overwrites:
            import yaml
            for kv in overwrites.split(","):
                k, v = kv.strip().split("=", 1)
                node = self.configs
                *parents, leaf = k.split(".")
                for p in parents:
                    node = node[p]
                node[leaf] = yaml.safe_load(v)
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        t = self.configs.get("train_conf", {})
        if t.get("enable_amp", False):
            raise _not_ported("train_conf.enable_amp (bf16 training)")
        if int(t.get("tensor_parallel", 1) or 1) > 1:
            raise _not_ported("train_conf.tensor_parallel")
        if self.configs.dataset_conf.get("on_device_frontend", False):
            raise _not_ported("dataset_conf.on_device_frontend")
        self.use_model = self.configs.use_model
        self.streaming = bool(self.configs.get("streaming", True))
        self.seed = int(self.configs.get("seed", 0))
        self.stop_train = False
        self.stop_eval = False
        self.model = None
        self.state = None

    # ------------------------------------------------------------------ #
    # data
    # ------------------------------------------------------------------ #
    def _setup_dataloader(self, is_train, augment_conf_path=None):
        d = self.configs.dataset_conf
        if is_train:
            check_no_augmentation(augment_conf_path)
        dataset = MASRDataset(
            self.configs.preprocess_conf,
            d.train_manifest if is_train else d.test_manifest,
            d.dataset_vocab, manifest_type=d.get("manifest_type", "txt"),
            min_duration=d.get("min_duration", 0),
            max_duration=d.get("max_duration", 20) if is_train else -1,
            train=is_train)
        if is_train:
            sampler = BatchShuffleSampler(len(dataset), d.batch_size,
                                          sortagrad=True, drop_last=True,
                                          seed=self.seed)
        else:
            sampler = BatchShuffleSampler(len(dataset), d.batch_size,
                                          shuffle=False, drop_last=False)
        loader = DataLoader(dataset, sampler,
                            num_workers=d.get("num_workers", 4))
        return dataset, sampler, loader

    # ------------------------------------------------------------------ #
    # model
    # ------------------------------------------------------------------ #
    def _setup_model(self, input_dim, vocab_size):
        d = self.configs.dataset_conf
        norm = FeatureNormalizer(d.mean_istd_path)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(self.seed)
            model = build_model(
                self.use_model, input_dim, vocab_size,
                streaming=self.streaming,
                encoder_conf=self.configs.get("encoder_conf"),
                decoder_conf=self.configs.get("decoder_conf"),
                model_conf=self.configs.get("model_conf"),
                cmvn=GlobalCMVN(norm.mean, norm.istd))
        init_type = str(self.configs.get("train_conf", {}).get(
            "init_type", "flax"))
        if init_type == "flax":
            flax_like_init(model, torch.Generator().manual_seed(self.seed))
        elif init_type != "torch_default":
            raise ValueError(f"unknown train_conf.init_type {init_type!r}")
        self.model = model.to(self.device)
        t = self.configs.get("train_conf", {})
        opt, sched, self.lr_schedule = build_optimizer(
            self.model.parameters(), self.configs.optimizer_conf)
        self.state = TrainState(self.model, opt, sched,
                                grad_clip=t.get("grad_clip", 5.0),
                                accum_grad=t.get("accum_grad", 1))
        return self.model

    def _save_dir(self, save_model_path):
        return os.path.join(
            save_model_path,
            f"{self.use_model}_"
            f"{'streaming' if self.streaming else 'non-streaming'}_"
            f"{self.configs.preprocess_conf.feature_method}")

    def _load_pretrained(self, path):
        """Shape-checked partial load: tensors whose name and shape match
        are copied, the rest keep their fresh init."""
        src, _ = ckpt.load_checkpoint(path)
        src = src["model"]
        own = self.model.state_dict()
        keep = {k: v for k, v in src.items()
                if k in own and tuple(v.shape) == tuple(own[k].shape)}
        if len(keep) < len(own):
            logger.warning(f"pretrained load skipped "
                           f"{len(own) - len(keep)} mismatched tensors")
        self.model.load_state_dict(keep, strict=False)

    # ------------------------------------------------------------------ #
    # train
    # ------------------------------------------------------------------ #
    def train(self, save_model_path="models/", resume_model=None,
              pretrained_model=None, augment_conf_path=None):
        t_conf = self.configs.train_conf
        dataset, sampler, loader = self._setup_dataloader(
            True, augment_conf_path)
        test_dataset, _, test_loader = self._setup_dataloader(False)
        self._setup_model(dataset.feature_dim, dataset.vocab_size)
        save_dir = self._save_dir(save_model_path)
        last_epoch, best_error = 0, float("inf")
        resume = resume_model or ckpt.latest_checkpoint(save_dir)
        if resume:
            state, meta = ckpt.load_checkpoint(resume)
            self.state.load_state_dict(state)
            last_epoch = int(meta.get("last_epoch", 0))
            best_error = float(meta.get("test_cer", meta.get(
                "test_wer", float("inf"))) or float("inf"))
            logger.info(f"resumed from {resume} at epoch {last_epoch}")
        elif pretrained_model:
            self._load_pretrained(pretrained_model)
            logger.info(f"loaded pretrained weights from {pretrained_model}")
        writer = ScalarWriter(self.configs.get("log_dir", "log"))
        max_epoch = t_conf.max_epoch
        log_interval = t_conf.get("log_interval", 100)
        save_interval = t_conf.get("save_interval_batches", 10000)
        metric_name = self.configs.get("metrics_type", "cer")
        for epoch in range(last_epoch, max_epoch):
            sampler.set_epoch(epoch)
            epoch_start = batch_start = time.time()
            losses = []
            for batch_id, batch in enumerate(loader):
                if self.stop_train:
                    logger.warning("training stopped by stop_train flag")
                    writer.close()
                    return
                reader_cost = time.time() - batch_start
                metrics = train_step(self.state, batch_to(batch, self.device),
                                     self.seed)
                loss = metrics["loss"]
                losses.append(loss)
                batch_cost = time.time() - batch_start
                if batch_id % log_interval == 0:
                    step = self.state.step
                    lr = self.lr_schedule(self.state.updates)
                    logger.info(
                        f"epoch [{epoch + 1}/{max_epoch}] batch "
                        f"[{batch_id}/{len(loader)}] loss {loss:.4f} "
                        f"lr {lr:.8f} reader_cost {reader_cost:.3f}s "
                        f"batch_cost {batch_cost:.3f}s")
                    writer.add_scalar("Train/Loss", loss, step)
                    writer.add_scalar("Train/lr", lr, step)
                if save_interval and batch_id > 0 and \
                        batch_id % save_interval == 0:
                    ckpt.save_checkpoint(
                        save_dir, epoch + 1, self.state.state_dict(),
                        metrics={"last_epoch": epoch,
                                 "mid_epoch_batch": batch_id})
                batch_start = time.time()
            logger.info(f"epoch {epoch + 1} finished in "
                        f"{time.time() - epoch_start:.1f}s, mean loss "
                        f"{np.mean(losses) if losses else float('nan'):.4f}")
            error, test_loss = self._evaluate_loader(test_loader,
                                                     test_dataset)
            logger.info(f"epoch {epoch + 1}: test {metric_name}={error:.5f} "
                        f"loss={test_loss:.4f}")
            writer.add_scalar(f"Test/{metric_name}", error, self.state.step)
            writer.add_scalar("Test/Loss", test_loss, self.state.step)
            is_best = error <= best_error
            best_error = min(error, best_error)
            ckpt.save_checkpoint(
                save_dir, epoch + 1, self.state.state_dict(),
                metrics={"last_epoch": epoch + 1,
                         f"test_{metric_name}": error,
                         "test_loss": float(test_loss)},
                best=is_best)
        writer.close()

    # ------------------------------------------------------------------ #
    # evaluate
    # ------------------------------------------------------------------ #
    def _evaluate_loader(self, loader, dataset, display_result=False,
                         decoder=None):
        """Mean error rate and mean loss over the loader, ctc_greedy."""
        decoder = decoder or "ctc_greedy"
        if decoder != "ctc_greedy":
            raise _not_ported(f"eval decoder {decoder!r}")
        tf = TextFeaturizer(self.configs.dataset_conf.dataset_vocab)
        metric = self.configs.get("metrics_type", "cer")
        errors, losses = [], []
        for batch in loader:
            if self.stop_eval:
                break
            loss, probs, lens = eval_step(self.model,
                                          batch_to(batch, self.device))
            results = greedy_decoder_batch(probs.cpu().numpy(),
                                           dataset.vocab_list,
                                           lens=lens.cpu().numpy())
            losses.append(loss)
            for i, (_, text) in enumerate(results):
                target = tf.detokenize(
                    batch["labels"][i][:batch["label_lens"][i]])
                if not target:
                    continue
                e = cer(target, text) if metric == "cer" else \
                    wer(target, text)
                errors.append(e)
                if display_result:
                    logger.info(f"ref: {target} | hyp: {text} | "
                                f"{metric}={e:.4f}")
        return (float(np.mean(errors)) if errors else 1.0,
                float(np.mean(losses)) if losses else 0.0)

    def evaluate(self, resume_model="models/best_model",
                 display_result=False, decoder=None):
        """Error rate and loss of a checkpoint on the test manifest."""
        dataset, _, loader = self._setup_dataloader(False)
        if self.model is None:
            self._setup_model(dataset.feature_dim, dataset.vocab_size)
        if resume_model and os.path.exists(resume_model):
            state, _ = ckpt.load_checkpoint(resume_model)
            self.model.load_state_dict(state["model"])
            logger.info(f"loaded model from {resume_model}")
        start = time.time()
        error, loss = self._evaluate_loader(loader, dataset, display_result,
                                            decoder)
        logger.info(f"evaluate done in {time.time() - start:.1f}s")
        return error, loss
