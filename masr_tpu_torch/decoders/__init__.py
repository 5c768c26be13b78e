from masr_tpu_torch.decoders.greedy import (greedy_decoder,
                                            greedy_decoder_batch,
                                            GreedyChunkDecoder)
