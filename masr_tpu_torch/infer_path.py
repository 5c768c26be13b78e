"""Recognize one audio file with an exported inference bundle on the
PyTorch port (the arguments of the repository's infer_path.py): short
audio (`predict`), long audio (`--is_long_audio True`: VAD segments,
`predict_long`) or the real-time demo (`--real_time_demo True`: 0.5 s
pieces through `predict_stream`):

    python -m masr_tpu_torch.infer_path --wav_path dataset/test.wav \
        --model_dir models/conformer_streaming_fbank/inference_model/
    python -m masr_tpu_torch.infer_path ... --use_gpu False     # the CPU
"""
import argparse
import functools
import time

from masr_tpu_torch.audio import AudioSegment
from masr_tpu_torch.infer.predictor import MASRPredictor
from masr_tpu_torch.utils.config import add_arguments, print_arguments
from masr_tpu_torch.utils.logger import setup_logger

logger = setup_logger()


def _ms(start):
    return int(round((time.time() - start) * 1000))


def main(argv=None):
    """→ the result {'text', 'score'} (the demo: the list of its results,
    the last with the whole stream's text)."""
    parser = argparse.ArgumentParser(description=__doc__)
    add_arg = functools.partial(add_arguments, argparser=parser)
    add_arg('wav_path',        str,  'dataset/test.wav',       "预测音频的路径")
    add_arg('model_dir',       str,  'models/conformer_streaming_fbank/inference_model/', "导出的预测模型文件夹路径")
    add_arg("use_gpu",         bool, True,   "是否使用GPU预测(False: CPU)")
    add_arg('is_long_audio',   bool, False,  "是否为长语音")
    add_arg('real_time_demo',  bool, False,  "是否使用实时语音识别演示")
    add_arg('use_pun',         bool, False,  "是否给识别结果加标点符号")
    add_arg('is_itn',          bool, False,  "是否对文本进行反标准化")
    add_arg('decoder',         str,  'ctc_greedy',  "解码器: ctc_greedy | ctc_beam_search | attention_rescoring | ctc_beam_search_device")
    add_arg('pun_model_dir',   str,  None,   "标点符号的模型文件夹路径")
    args = parser.parse_args(argv)
    print_arguments(args)
    predictor = MASRPredictor(model_dir=args.model_dir, decoder=args.decoder,
                              use_pun=args.use_pun,
                              pun_model_dir=args.pun_model_dir,
                              device="cuda" if args.use_gpu else "cpu")
    if args.real_time_demo:
        seg = AudioSegment.from_file(args.wav_path)
        samples, sr = seg.samples, seg.sample_rate
        interval = int(0.5 * sr)
        results = []
        for i in range(0, len(samples), interval):
            start = time.time()
            result = predictor.predict_stream(
                audio_data=samples[i:i + interval],
                is_end=i + interval >= len(samples), use_pun=args.use_pun,
                is_itn=args.is_itn, sample_rate=sr)
            if result is None:
                continue
            results.append(result)
            logger.info(f"【实时结果】：消耗时间："
                        f"{int((time.time() - start) * 1000)}ms, "
                        f"识别结果: {result['text']}")
        predictor.reset_stream()
        return results
    start = time.time()
    if args.is_long_audio:
        result = predictor.predict_long(audio_data=args.wav_path,
                                        use_pun=args.use_pun,
                                        is_itn=args.is_itn)
        logger.info(f"长语音识别结果，消耗时间：{_ms(start)}ms, "
                    f"识别结果: {result['text']}, 得分: {result['score']}")
    else:
        result = predictor.predict(audio_data=args.wav_path,
                                   use_pun=args.use_pun, is_itn=args.is_itn)
        logger.info(f"消耗时间：{_ms(start)}ms, 识别结果: {result['text']}, "
                    f"得分: {result['score']}")
    return result


if __name__ == "__main__":
    main()
