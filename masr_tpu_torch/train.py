"""Train a model on the GPU with the PyTorch port (the arguments and
defaults of the repository's train.py, augmentation config
configs/augmentation.json included):

    python -m masr_tpu_torch.train --configs configs/conformer.yml
    python -m masr_tpu_torch.train --configs configs/squeezeformer.yml
    python -m masr_tpu_torch.train --configs configs/efficient_conformer.yml
    python -m masr_tpu_torch.train --configs configs/deepspeech2.yml
"""
import argparse

from masr_tpu_torch.training.trainer import MASRTrainer


def _bool(v):
    return str(v).lower() in ("1", "true", "yes", "y", "on")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--configs", default="configs/conformer.yml",
                   help="config file (YAML)")
    p.add_argument("--local_rank", type=int, default=0,
                   help="accepted for compatibility; one GPU is used")
    p.add_argument("--use_gpu", type=_bool, default=True,
                   help="train on the GPU (False: the CPU)")
    p.add_argument("--augment_conf_path",
                   default="configs/augmentation.json",
                   help="data augmentation config (JSON); a missing file "
                        "trains without augmentation")
    p.add_argument("--save_model_path", default="models/",
                   help="where checkpoints are written")
    p.add_argument("--resume_model", default=None,
                   help="checkpoint to resume from (default: last_model)")
    p.add_argument("--pretrained_model", default=None,
                   help="checkpoint whose matching weights start training")
    p.add_argument("--overwrites", default=None,
                   help='config overrides, e.g. "train_conf.max_epoch=100"')
    args = p.parse_args(argv)
    trainer = MASRTrainer(configs=args.configs,
                          device="cuda" if args.use_gpu else "cpu",
                          overwrites=args.overwrites)
    trainer.train(save_model_path=args.save_model_path,
                  resume_model=args.resume_model,
                  pretrained_model=args.pretrained_model,
                  augment_conf_path=args.augment_conf_path)


if __name__ == "__main__":
    main()
