"""Model registry (port of masr_tpu/models/registry.py): `use_model`
selects the family; encoder_conf and decoder_conf are splatted into the
constructors and model_conf carries the loss weights (ctc_weight,
lsm_weight, reverse_weight, length_normalized_loss). The port has the
Conformer and the Squeezeformer, serving and training."""
from masr_tpu_torch.models.conformer import ConformerModel
from masr_tpu_torch.models.squeezeformer import SqueezeformerModel

_FAMILIES = {"conformer": ConformerModel, "squeezeformer": SqueezeformerModel}


def build_model(use_model: str, input_dim: int, vocab_size: int,
                streaming: bool = True, encoder_conf=None, decoder_conf=None,
                model_conf=None, cmvn=None):
    if use_model in _FAMILIES:
        return _FAMILIES[use_model](input_dim=input_dim,
                                    vocab_size=vocab_size, cmvn=cmvn,
                                    streaming=streaming,
                                    encoder_conf=encoder_conf,
                                    decoder_conf=decoder_conf,
                                    **dict(model_conf or {}))
    if use_model in ("deepspeech2", "efficient_conformer"):
        raise NotImplementedError(f"model family {use_model!r} is not "
                                  "ported yet")
    raise ValueError(f"unknown use_model: {use_model}")
