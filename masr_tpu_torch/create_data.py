"""Prepare the data of the PyTorch port: the train and test manifests, the
noise manifest, the vocabulary and the CMVN statistics (the arguments of
the repository's create_data.py), with no JAX installed:

    python -m masr_tpu_torch.create_data --configs configs/conformer.yml \
        --annotation_path dataset/annotation/
    python -m masr_tpu_torch.create_data ... --is_merge_audio True
    python -m masr_tpu_torch.create_data ... --use_gpu False     # the CPU

The work is host code; use_gpu picks the trainer's device, as the other
CLIs (True needs a card).
"""
import argparse
import functools

from masr_tpu_torch.data.manifest import merge_audio
from masr_tpu_torch.training.trainer import MASRTrainer
from masr_tpu_torch.utils.config import add_arguments, print_arguments


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    add_arg = functools.partial(add_arguments, argparser=parser)
    add_arg('configs',          str,  'configs/conformer.yml',    "配置文件")
    add_arg("use_gpu",          bool, True,                       "是否使用GPU(False: CPU)")
    add_arg('annotation_path',  str,  'dataset/annotation/',      "标注文件的路径")
    add_arg('noise_dir',        str,  'dataset/audio/noise/',     "噪声音频存放的文件夹路径")
    add_arg('num_samples',      int,  1000000,                    "用于计算均值和标准值的音频数量，当为-1使用全部数据")
    add_arg('count_threshold',  int,  2,                          "字符计数的截断阈值，0为不做限制")
    add_arg('is_change_frame_rate', bool, True,                   "是否统一改变音频的采样率")
    add_arg('max_test_manifest', int, 10000,                      "测试数据列表的最大数量")
    add_arg('only_keep_zh_en',  bool, True,                       "是否只保留中文和英文字符")
    add_arg('is_merge_audio',   bool, False,                      "是否将多个短音频合并成长音频，以减少音频文件数量")
    add_arg('max_duration',     int,  600,                        "合并音频的最大长度，单位秒")
    add_arg('save_audio_path',  str,  'dataset/audio/merge_audio', "合并音频的保存路径")
    args = parser.parse_args(argv)
    print_arguments(args)
    if args.is_merge_audio:
        # the .txt annotations are replaced by .merge.json, so that the
        # manifests do not count them twice (the source audio is kept)
        merge_audio(args.annotation_path, args.save_audio_path,
                    max_duration=args.max_duration, remove_original=True)
    trainer = MASRTrainer(configs=args.configs,
                          device="cuda" if args.use_gpu else "cpu")
    trainer.create_data(annotation_path=args.annotation_path,
                        noise_dir=args.noise_dir,
                        num_samples=args.num_samples,
                        count_threshold=args.count_threshold,
                        is_change_frame_rate=args.is_change_frame_rate,
                        max_test_manifest=args.max_test_manifest,
                        only_keep_zh_en=args.only_keep_zh_en)


if __name__ == "__main__":
    main()
