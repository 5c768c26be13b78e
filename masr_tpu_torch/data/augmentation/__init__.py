"""Host augmentation (port of masr_tpu/data/augmentation)."""
from masr_tpu_torch.data.augmentation.pipeline import AugmentationPipeline

__all__ = ["AugmentationPipeline"]
