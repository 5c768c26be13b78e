"""Model registry (port of masr_tpu/models/registry.py): `use_model`
selects the family; encoder_conf and decoder_conf are splatted into the
constructors and model_conf carries the loss weights (ctc_weight,
lsm_weight, reverse_weight, length_normalized_loss). The port has all
four families, serving and training: the Conformer, the Squeezeformer,
the Efficient-Conformer and DeepSpeech2 (whose decoder_conf is {} and
which takes no model_conf).

dtype (masr_tpu's build_model(dtype=)): the compute dtype, f32 or bf16.
Every family serves in bf16 (parameters f32, products in bf16): the
Conformer through its layer kernels' bf16 modes (rows 1, 2 and 5), the
Squeezeformer through rows 6 and 8's, the Efficient-Conformer's tail
through row 1's (row 5's when static-chunk), DeepSpeech2 with no kernel
(its recurrence is XLA ops in masr_tpu). The Conformer and the
layer_norm Squeezeformer also train in bf16 (masr_tpu's enable_amp,
through rows 3 and 7's bf16 modes); the other routes' loss paths raise on
bf16. Any other dtype raises; nothing falls back to f32."""
import torch

from masr_tpu_torch.models.conformer import ConformerModel
from masr_tpu_torch.models.deepspeech2 import DeepSpeech2Model
from masr_tpu_torch.models.efficient_conformer import EfficientConformerModel
from masr_tpu_torch.models.squeezeformer import SqueezeformerModel

_FAMILIES = {"conformer": ConformerModel, "squeezeformer": SqueezeformerModel,
             "efficient_conformer": EfficientConformerModel,
             "deepspeech2": DeepSpeech2Model}


def build_model(use_model: str, input_dim: int, vocab_size: int,
                streaming: bool = True, encoder_conf=None, decoder_conf=None,
                model_conf=None, cmvn=None, dtype=torch.float32):
    if use_model not in _FAMILIES:
        raise ValueError(f"unknown use_model: {use_model}")
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"dtype {dtype}: the port computes in f32 or bf16")
    extra = {} if dtype == torch.float32 else {"dtype": dtype}
    return _FAMILIES[use_model](input_dim=input_dim, vocab_size=vocab_size,
                                cmvn=cmvn, streaming=streaming,
                                encoder_conf=encoder_conf,
                                decoder_conf=decoder_conf,
                                **dict(model_conf or {}), **extra)
