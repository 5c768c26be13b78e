"""Evaluate a checkpoint of the PyTorch port on the config's test manifest
(the arguments of the repository's eval.py):

    python -m masr_tpu_torch.eval --configs configs/conformer.yml \
        --resume_model models/conformer_streaming_fbank/best_model/
    python -m masr_tpu_torch.eval ... --decoder ctc_beam_search_device
    python -m masr_tpu_torch.eval ... --use_gpu False     # the CPU
"""
import argparse
import functools
import time

from masr_tpu_torch.training.trainer import MASRTrainer
from masr_tpu_torch.utils.config import add_arguments, print_arguments
from masr_tpu_torch.utils.logger import setup_logger

logger = setup_logger()


def main(argv=None):
    """→ (error rate, loss)."""
    parser = argparse.ArgumentParser(description=__doc__)
    add_arg = functools.partial(add_arguments, argparser=parser)
    add_arg('configs',          str,   'configs/conformer.yml',  "配置文件")
    add_arg("use_gpu",          bool,  True,                     "是否使用GPU评估(False: CPU)")
    add_arg('display_result',   bool,  False,                    "是否打印每条识别结果")
    add_arg('resume_model',     str,   'models/conformer_streaming_fbank/best_model/', "模型的路径")
    add_arg('decoder',          str,   None,  "解码器: ctc_greedy | ctc_beam_search | attention_rescoring | ctc_beam_search_device (默认用配置文件)")
    add_arg('overwrites',       str,   None,                     '覆盖配置文件中的参数，多个用逗号隔开')
    args = parser.parse_args(argv)
    print_arguments(args)
    trainer = MASRTrainer(configs=args.configs,
                          device="cuda" if args.use_gpu else "cpu",
                          overwrites=args.overwrites)
    start = time.time()
    error_rate, loss = trainer.evaluate(resume_model=args.resume_model,
                                        display_result=args.display_result,
                                        decoder=args.decoder)
    metrics_type = trainer.configs.get('metrics_type', 'cer')
    logger.info(f"消耗时间：{int(time.time() - start)}s, {metrics_type}: "
                f"{error_rate:.5f}")
    return error_rate, loss


if __name__ == "__main__":
    main()
