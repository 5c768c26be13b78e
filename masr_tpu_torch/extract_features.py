"""Precompute the features of the config's train and test manifests into
.npy slabs and `<manifest>.feature` manifests, which the PyTorch port's
trainer reads (the arguments of the repository's extract_features.py):

    python -m masr_tpu_torch.extract_features --configs configs/conformer.yml
    python -m masr_tpu_torch.extract_features ... --use_gpu False  # the CPU

Train on them by pointing dataset_conf.train_manifest / test_manifest at
the .feature manifests.
"""
import argparse
import functools

from masr_tpu_torch.training.trainer import MASRTrainer
from masr_tpu_torch.utils.config import add_arguments, print_arguments


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    add_arg = functools.partial(add_arguments, argparser=parser)
    add_arg('configs',      str,  'configs/conformer.yml',  "配置文件")
    add_arg("use_gpu",      bool, True,                     "是否使用GPU(False: CPU)")
    add_arg('save_dir',     str,  'dataset/features',       "特征保存路径")
    add_arg('max_duration', int,  100,                      "提取特征的最大时长，单位秒")
    args = parser.parse_args(argv)
    print_arguments(args)
    trainer = MASRTrainer(configs=args.configs,
                          device="cuda" if args.use_gpu else "cpu")
    trainer.extract_features(save_dir=args.save_dir,
                             max_duration=args.max_duration)


if __name__ == "__main__":
    main()
