from multimodal_unlearning_tpu_torch.data.processor import MMProcessor, preprocess_image
from multimodal_unlearning_tpu_torch.data.tokenizer import ByteTokenizer

__all__ = ["ByteTokenizer", "MMProcessor", "preprocess_image"]
