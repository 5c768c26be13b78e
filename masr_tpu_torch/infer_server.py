"""The PyTorch port's ASR server, REST and WebSocket (the arguments of the
repository's infer_server.py):

    python -m masr_tpu_torch.infer_server \
        --model_dir models/conformer_streaming_fbank/inference_model/
    python -m masr_tpu_torch.infer_server ... --max_streams 32  # engine
    python -m masr_tpu_torch.infer_server ... --use_gpu False   # the CPU
"""
import argparse
import functools

from masr_tpu_torch.infer.predictor import MASRPredictor
from masr_tpu_torch.infer.server import ASRServer
from masr_tpu_torch.utils.config import add_arguments, print_arguments


def build_server(argv=None):
    """Parse the arguments → the ASRServer (not started)."""
    parser = argparse.ArgumentParser(description=__doc__)
    add_arg = functools.partial(add_arguments, argparser=parser)
    add_arg('host',            str,  '0.0.0.0',  "监听主机的IP地址")
    add_arg('port',            int,  5000,       "REST服务所使用的端口号")
    add_arg('ws_port',         int,  5001,       "WebSocket流式识别端口号")
    add_arg('model_dir',       str,  'models/conformer_streaming_fbank/inference_model/', "导出的预测模型文件夹路径")
    add_arg("use_gpu",         bool, True,   "是否使用GPU预测(False: CPU)")
    add_arg('use_pun',         bool, False,  "是否给识别结果加标点符号")
    add_arg('is_itn',          bool, False,  "是否对文本进行反标准化")
    add_arg('decoder',         str,  'ctc_greedy', "解码器: ctc_greedy | ctc_beam_search | attention_rescoring | ctc_beam_search_device")
    add_arg('pun_model_dir',   str,  None,   "标点符号的模型文件夹路径")
    add_arg('max_streams',     int,  0,      "并发流式识别路数(>1 时用批量引擎，一次步进所有流)")
    add_arg('tick_chunks',     int,  1,      "批量引擎每次派发合并的块数(k>1 吞吐模式，首包延迟增加(k-1)*0.64s)")
    add_arg('pos_table_len',   int,  8192,   "批量引擎位置表行数(约 len*40ms 流长后切换到精确位置，无精度损失；按会话时长设置)")
    args = parser.parse_args(argv)
    print_arguments(args)
    predictor = MASRPredictor(model_dir=args.model_dir, decoder=args.decoder,
                              use_pun=args.use_pun,
                              pun_model_dir=args.pun_model_dir,
                              device="cuda" if args.use_gpu else "cpu")
    return ASRServer(predictor, host=args.host, port=args.port,
                     ws_port=args.ws_port, use_pun=args.use_pun,
                     is_itn=args.is_itn, max_streams=args.max_streams,
                     tick_chunks=args.tick_chunks,
                     pos_table_len=args.pos_table_len)


def main(argv=None):
    build_server(argv).start(block=True)


if __name__ == "__main__":
    main()
