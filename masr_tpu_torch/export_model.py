"""Export a checkpoint of the PyTorch port as an inference bundle in
masr_tpu's format (the arguments of the repository's export_model.py):

    python -m masr_tpu_torch.export_model --configs configs/conformer.yml \
        --resume_model models/conformer_streaming_fbank/best_model/
    python -m masr_tpu_torch.export_model ... --save_quant int8   # or bf16
    python -m masr_tpu_torch.export_model ... --use_gpu False     # the CPU
"""
import argparse
import functools

from masr_tpu_torch.training.trainer import MASRTrainer
from masr_tpu_torch.utils.config import add_arguments, print_arguments


def parse_quant(value):
    """--save_quant: bf16 | int8, True as an alias of bf16, False / empty
    for f32."""
    quant = (value or "").strip().lower() or None
    if quant in ("true", "1"):
        return "bf16"
    if quant in ("false", "0"):
        return None
    return quant


def main(argv=None):
    """→ the bundle directory."""
    parser = argparse.ArgumentParser(description=__doc__)
    add_arg = functools.partial(add_arguments, argparser=parser)
    add_arg('configs',          str,  'configs/conformer.yml',    "配置文件")
    add_arg("use_gpu",          bool, True,                       "是否使用GPU导出(False: CPU)")
    add_arg('save_model_path',  str,  'models/',                  "模型保存的路径")
    add_arg('resume_model',     str,  'models/conformer_streaming_fbank/best_model/', "准备导出的模型路径")
    add_arg('save_quant',       str,  None,                       "量化导出: bf16(半精度) 或 int8(仅权重逐通道量化，产物约1/4大小)")
    add_arg('overwrites',       str,  None,                       '覆盖配置文件中的参数，多个用逗号隔开')
    args = parser.parse_args(argv)
    print_arguments(args)
    trainer = MASRTrainer(configs=args.configs,
                          device="cuda" if args.use_gpu else "cpu",
                          overwrites=args.overwrites)
    return trainer.export(save_model_path=args.save_model_path,
                          resume_model=args.resume_model,
                          quant=parse_quant(args.save_quant))


if __name__ == "__main__":
    main()
