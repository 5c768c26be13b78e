"""MASRTrainer: training, evaluation and export on one GPU (port of
masr_tpu/training/trainer.py: _setup_dataloader :153, _setup_model :225,
train :282, _resolve_eval_decoder :417, _rescore_batch :444,
_evaluate_loader :477, evaluate :569, export :593).

Same config schema and checkpoint semantics as masr_tpu: per-epoch
checkpoints with last/best retention and auto-resume from last_model,
mid-epoch saves, JSONL scalars, an end-of-epoch ctc_greedy evaluation;
`evaluate` decodes with the config's `decoder` (ctc_greedy,
ctc_beam_search, attention_rescoring or ctc_beam_search_device, with
ctc_beam_search_decoder_conf) unless told another; `export` writes a
checkpoint as a masr_tpu inference bundle (f32, bf16 or int8).
On the card the CTC loss runs the CTC kernel (forward and backward) and
every encoder layer of every step its family's training-layer kernel: the
Conformer's, or the Squeezeformer's with a layer_norm conv module; the
Efficient-Conformer trains its grouped and stride layers eagerly and its
plain tail through the Conformer's kernel (with a layer_norm conv module);
a BatchNorm conv module trains eager layers, whose running statistics
travel in the model's state_dict (checkpoints, resume) and are kept after
a non-finite step, as in masr_tpu. DeepSpeech2 trains its recurrence
through torch.nn.LSTM / GRU (cuDNN on the card) and its CTC loss through
the CTC kernel; its eval takes ctc_beam_search for attention_rescoring, as
masr_tpu's does. Training is f32 (TF32 off), or with train_conf.enable_amp
bf16 as masr_tpu's (build_model(dtype=bf16): f32 parameters, optimizer,
grad clipping and non-finite skip; the encoder's products in bf16 through
the training kernels' bf16 modes, the CTC and attention losses in f32;
cuBLAS's bf16 products keep f32 sums) for the Conformer and the
layer_norm Squeezeformer; `evaluate` runs the bf16 model in eval mode (the
bf16 serving routes) and `export` writes the f32 parameters, as
masr_tpu's does.

Training as masr_tpu's train.py runs it: `augment_conf_path` (an
augmentation JSON; train's default, as the CLI's and masr_tpu's, is
configs/augmentation.json) turns on host augmentation in the training set
(data/augmentation; its specaug
and specsub params also drive the on-device frontend); with
dataset_conf.on_device_frontend the loaders yield int16-scale waveforms
(collate_waveforms, bucketed to sample_bucket samples) and every train
step runs fbank, SpecAugment and SpecSub on the card before the encoder
(ops/specaug.py; eval takes the deterministic fbank); manifest_type binary
reads `<manifest>.data`; optimizer_conf.fused runs torch's fused Adam.

Not ported, each raising NotImplementedError before a model is built:
enable_amp for the BatchNorm Squeezeformer, the Efficient-Conformer and
DeepSpeech2 (ROADMAP.md queue 1, item 2) and tensor-parallel training
(item 6); absent: multi-host sampling, create_data and
extract_features.
"""
import os
import time

import numpy as np
import torch

from masr_tpu_torch.data.audio_featurizer import AudioFeaturizer
from masr_tpu_torch.data.augmentation.pipeline import enabled_items
from masr_tpu_torch.data.collate import collate_waveforms
from masr_tpu_torch.data.dataset import MASRDataset
from masr_tpu_torch.data.loader import DataLoader
from masr_tpu_torch.data.normalizer import FeatureNormalizer
from masr_tpu_torch.data.sampler import BatchShuffleSampler
from masr_tpu_torch.data.text_featurizer import TextFeaturizer
from masr_tpu_torch.decoders.device_beam import (decode_batch_device,
                                                 device_beam_conf)
from masr_tpu_torch.decoders.greedy import greedy_decoder_batch
from masr_tpu_torch.decoders.rescoring import rescore_nbest
from masr_tpu_torch.infer.inference_model import resolve_device
from masr_tpu_torch.models.cmvn import GlobalCMVN
from masr_tpu_torch.models.registry import build_model
from masr_tpu_torch.models.weights import (flax_like_init,
                                           to_flax_variables,
                                           torch_default_like_init)
from masr_tpu_torch.optimizer.schedulers import build_optimizer
from masr_tpu_torch.training import checkpoints as ckpt
from masr_tpu_torch.training.logging_util import ScalarWriter
from masr_tpu_torch.training.train_state import (TrainState, batch_to,
                                                 eval_step,
                                                 eval_step_rescoring,
                                                 train_step)
from masr_tpu_torch.utils.config import dict_to_object, load_config
from masr_tpu_torch.utils.logger import setup_logger
from masr_tpu_torch.utils.metrics import cer, wer

logger = setup_logger()


def _not_ported(what, item):
    return NotImplementedError(f"{what} is not ported (ROADMAP.md queue 1, "
                               f"item {item})")


def _amp_not_ported(configs):
    """The enable_amp routes not ported (None when the model's is): every
    family but the Conformer and a layer_norm-conv Squeezeformer."""
    family = configs.use_model
    if family == "conformer":
        return None
    if family == "squeezeformer":
        norm = (configs.get("encoder_conf") or {}).get("cnn_norm_type",
                                                       "batch_norm")
        if norm == "layer_norm":
            return None
        return "the BatchNorm Squeezeformer"
    return {"efficient_conformer": "the Efficient-Conformer",
            "deepspeech2": "DeepSpeech2"}.get(family, family)


class MASRTrainer(object):
    def __init__(self, configs, use_gpu=True, overwrites=None, device=None):
        """configs: a YAML path or a dict (masr_tpu's schema); use_gpu
        (masr_tpu's keyword, as the root train.py passes it): the card
        (raises without one) or, False, the CPU; device: "cuda" or "cpu",
        which overrides use_gpu; overwrites: "a.b=value,..." (values parsed
        as YAML)."""
        if device is None:
            device = "cuda" if use_gpu else "cpu"
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
        t = self.configs.get("train_conf", {})
        self.amp = bool(t.get("enable_amp", False))
        if self.amp and _amp_not_ported(self.configs):
            raise _not_ported("train_conf.enable_amp (bf16 training) of "
                              + _amp_not_ported(self.configs), 2)
        if int(t.get("tensor_parallel", 1) or 1) > 1:
            raise _not_ported("train_conf.tensor_parallel", 6)
        if self.device.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
            if self.amp:
                torch.backends.cuda.matmul.\
                    allow_bf16_reduced_precision_reduction = False
        self.use_model = self.configs.use_model
        self.streaming = bool(self.configs.get("streaming", True))
        self.seed = int(self.configs.get("seed", 0))
        self.stop_train = False
        self.stop_eval = False
        self.model = None
        self.state = None
        self.frontend = None

    # ------------------------------------------------------------------ #
    # data
    # ------------------------------------------------------------------ #
    def _setup_dataloader(self, is_train, augment_conf_path=None):
        """The dataset, its batch sampler and loader (masr_tpu/training/
        trainer.py:153-197): the training set augments with
        augment_conf_path when that file exists (remembered for the
        device frontend's params); binary manifests read
        `<manifest>.data`; with on_device_frontend the items are
        waveforms, collated by collate_waveforms."""
        d = self.configs.dataset_conf
        aug = "{}"
        if is_train and augment_conf_path \
                and os.path.exists(augment_conf_path):
            aug = augment_conf_path
            self._augment_conf_path = aug
        manifest = d.train_manifest if is_train else d.test_manifest
        if d.get("manifest_type") == "binary" \
                and not manifest.endswith(".data"):
            manifest = manifest + ".data"
        on_device = bool(d.get("on_device_frontend", False))
        dataset = MASRDataset(
            self.configs.preprocess_conf, manifest,
            d.dataset_vocab, manifest_type=d.get("manifest_type", "txt"),
            min_duration=d.get("min_duration", 0),
            max_duration=d.get("max_duration", 20) if is_train else -1,
            augmentation_config=aug, train=is_train,
            return_waveform=on_device)
        if is_train:
            sampler = BatchShuffleSampler(len(dataset), d.batch_size,
                                          sortagrad=True, drop_last=True,
                                          seed=self.seed)
        else:
            sampler = BatchShuffleSampler(len(dataset), d.batch_size,
                                          shuffle=False, drop_last=False)
        collate = None
        if on_device:
            # masr_tpu shuffles waveform batches with a RandomState of the
            # config's seed (feature batches with the loader's, seeded 0)
            bucket = int(d.get("sample_bucket", 16000))
            rng = np.random.RandomState(self.seed)

            def collate(items, _):
                return collate_waveforms(items, sample_bucket=bucket,
                                         rng=rng)

        loader = DataLoader(dataset, sampler,
                            num_workers=d.get("num_workers", 4),
                            collate=collate)
        return dataset, sampler, loader

    def _device_frontend(self):
        """The on-device frontend (ops/specaug.py make_device_frontend) when
        dataset_conf.on_device_frontend is set, its SpecAugment and SpecSub
        params from the augmentation JSON's enabled specaug and specsub
        items; None otherwise."""
        if not bool(self.configs.dataset_conf.get("on_device_frontend",
                                                  False)):
            return None
        from masr_tpu_torch.ops.specaug import make_device_frontend
        confs = {item.get("type"): item.get("params") for item in
                 enabled_items(getattr(self, "_augment_conf_path", None))}
        return make_device_frontend(self.configs.preprocess_conf,
                                    confs.get("specaug"),
                                    confs.get("specsub"))

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
                cmvn=GlobalCMVN(norm.mean, norm.istd),
                dtype=torch.bfloat16 if self.amp else torch.float32)
        init_type = str(self.configs.get("train_conf", {}).get(
            "init_type", "flax"))
        if init_type == "flax":
            flax_like_init(model, torch.Generator().manual_seed(self.seed))
        elif init_type == "torch_default":
            torch_default_like_init(model,
                                    torch.Generator().manual_seed(self.seed))
        else:
            raise ValueError(f"unknown train_conf.init_type {init_type!r}")
        self.model = model.to(self.device)
        t = self.configs.get("train_conf", {})
        grad_clip = t.get("grad_clip", 5.0)
        opt, sched, self.lr_schedule = build_optimizer(
            self.model.parameters(), self.configs.optimizer_conf)
        self.frontend = self._device_frontend()
        self.state = TrainState(self.model, opt, sched, grad_clip=grad_clip,
                                accum_grad=t.get("accum_grad", 1),
                                frontend=self.frontend)
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
              pretrained_model=None,
              augment_conf_path="configs/augmentation.json"):
        """masr_tpu's train: augment_conf_path defaults to its
        configs/augmentation.json (relative to the working directory; a
        missing file, or None, trains unaugmented)."""
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
            # training-time eval decodes greedily, as masr_tpu's does
            error, test_loss = self._evaluate_loader(
                test_loader, test_dataset, decoder="ctc_greedy")
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
    def _resolve_eval_decoder(self, vocab_list, decoder=None):
        """The eval decoder: `decoder`, else the config's `decoder` key;
        builds the host beam engine once for ctc_beam_search and
        attention_rescoring (falling back to ctc_greedy with a warning
        when it cannot be built, as masr_tpu does)."""
        decoder = decoder or self.configs.get("decoder", "ctc_greedy")
        if decoder not in ("ctc_greedy", "ctc_beam_search",
                           "attention_rescoring", "ctc_beam_search_device"):
            raise ValueError(f"unknown eval decoder {decoder!r}")
        if decoder == "attention_rescoring" \
                and not self.model.has_attention_decoder:
            logger.warning(f"{self.use_model} has no attention decoder; eval "
                           "attention_rescoring falls back to ctc_beam_search")
            decoder = "ctc_beam_search"
        if decoder in ("ctc_beam_search", "attention_rescoring") \
                and getattr(self, "_eval_beam_decoder", None) is None:
            from masr_tpu_torch.decoders.beam_search import BeamSearchDecoder
            conf = dict(self.configs.get("ctc_beam_search_decoder_conf")
                        or {})
            for k in ("rescoring_nbest", "rescoring_ctc_weight",
                      "rescoring_reverse_weight"):
                conf.pop(k, None)
            try:
                self._eval_beam_decoder = BeamSearchDecoder(vocab_list,
                                                            **conf)
            except Exception as e:
                logger.warning(f"beam search decoder unavailable ({e}); "
                               "falling back to ctc_greedy for eval")
                decoder = "ctc_greedy"
        return decoder

    def _rescore_batch(self, enc, probs, lens, tf, nbest_n, ctc_weight,
                       reverse_weight):
        """Per utterance: the CTC n-best rescored by the attention decoder
        over its encoder rows (decoders/rescoring.py) → [(score, text)]."""
        results = []
        for i in range(probs.shape[0]):
            best = rescore_nbest(
                self.model, enc[i:i + 1], lens[i],
                self._eval_beam_decoder.decode_nbest(
                    probs[i][: int(lens[i])], nbest_n),
                ctc_weight, reverse_weight, nbest_n)
            results.append((0.0, "") if best is None
                           else (best[0], tf.detokenize(best[1])))
        return results

    def _device_beam_conf(self, vocab_list):
        """The device beam's keywords from ctc_beam_search_decoder_conf,
        its dense-bigram table built once."""
        if getattr(self, "_device_beam", None) is None:
            self._device_beam = device_beam_conf(
                self.configs.get("ctc_beam_search_decoder_conf") or {},
                vocab_list, self.device)
        return self._device_beam

    def _evaluate_loader(self, loader, dataset, display_result=False,
                         decoder=None):
        """Mean error rate and mean loss over the loader with the eval
        decoder (_resolve_eval_decoder)."""
        vocab_list = dataset.vocab_list
        decoder = self._resolve_eval_decoder(vocab_list, decoder)
        tf = TextFeaturizer(self.configs.dataset_conf.dataset_vocab)
        metric = self.configs.get("metrics_type", "cer")
        if decoder == "attention_rescoring":
            m_conf = self.configs.get("model_conf") or {}
            d_conf = self.configs.get("decoder_conf") or {}
            ctc_weight = float(m_conf.get("ctc_weight", 0.3))
            reverse_weight = float(m_conf.get("reverse_weight", 0.0)) \
                if int(d_conf.get("r_num_blocks", 0)) > 0 else 0.0
            nbest_n = int((self.configs.get("ctc_beam_search_decoder_conf")
                           or {}).get("rescoring_nbest", 10))
        errors, losses = [], []
        for batch in loader:
            if self.stop_eval:
                break
            batch_dev = batch_to(batch, self.device)
            if decoder == "attention_rescoring":
                loss, enc, probs, lens = eval_step_rescoring(
                    self.model, batch_dev, self.frontend)
                results = self._rescore_batch(
                    enc, probs.cpu().numpy(), lens.cpu().numpy(), tf,
                    nbest_n, ctc_weight, reverse_weight)
            else:
                loss, probs, lens = eval_step(self.model, batch_dev,
                                              self.frontend)
                if decoder == "ctc_beam_search_device":
                    results = decode_batch_device(
                        probs, lens, vocab_list,
                        **self._device_beam_conf(vocab_list))
                elif decoder == "ctc_beam_search":
                    probs, lens = probs.cpu().numpy(), lens.cpu().numpy()
                    results = self._eval_beam_decoder.\
                        decode_batch_beam_search_offline(
                            [probs[i][: int(lens[i])]
                             for i in range(probs.shape[0])])
                else:
                    results = greedy_decoder_batch(
                        probs.cpu().numpy(), vocab_list,
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
        """Error rate and loss of a checkpoint on the test manifest; decoder
        None decodes with the config's `decoder` key."""
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

    # ------------------------------------------------------------------ #
    # export
    # ------------------------------------------------------------------ #
    def export(self, save_model_path="models/",
               resume_model="models/best_model", half=False, quant=None):
        """Checkpoint → inference bundle in masr_tpu's format, under
        {save_model_path}/{use_model}_{streaming|non-streaming}_
        {feature_method}/inference_model; quant: None (f32), 'bf16'
        (half=True is an alias) or 'int8' (weight-only, per channel).
        → the bundle directory."""
        from masr_tpu_torch.infer.bundle import save_inference_bundle
        d = self.configs.dataset_conf
        featurizer = AudioFeaturizer(train=False,
                                     **self.configs.preprocess_conf)
        tf = TextFeaturizer(d.dataset_vocab)
        if self.model is None:
            self._setup_model(featurizer.feature_dim, tf.vocab_size)
        state, _ = ckpt.load_checkpoint(resume_model)
        self.model.load_state_dict(state["model"])
        norm = FeatureNormalizer(d.mean_istd_path)
        out_dir = os.path.join(self._save_dir(save_model_path),
                               "inference_model")
        save_inference_bundle(
            out_dir, self.use_model, self.streaming, featurizer.feature_dim,
            tf.vocab_list, norm.mean, norm.istd,
            self.configs.get("encoder_conf"), self.configs.get("decoder_conf"),
            self.configs.get("model_conf"), self.configs.preprocess_conf,
            to_flax_variables(self.model.state_dict()), half=half,
            quant=quant)
        logger.info(f"inference bundle exported to {out_dir}")
        return out_dir
