from multimodal_unlearning_tpu_torch.data.datasets import (
    ImageCaptioningDataset, MMDatasetQA, MMMixedDataset, MMMixedForgetDataset,
    SyntheticClearData)
from multimodal_unlearning_tpu_torch.data.loader import DataLoader
from multimodal_unlearning_tpu_torch.data.processor import MMProcessor, preprocess_image
from multimodal_unlearning_tpu_torch.data.tokenizer import ByteTokenizer

__all__ = ["ByteTokenizer", "MMProcessor", "preprocess_image", "MMDatasetQA",
           "ImageCaptioningDataset", "MMMixedDataset", "MMMixedForgetDataset",
           "SyntheticClearData", "DataLoader"]
