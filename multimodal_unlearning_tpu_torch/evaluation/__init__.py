from multimodal_unlearning_tpu_torch.evaluation import (
    evaluator, generate, metrics, rouge, sampling)

__all__ = ["evaluator", "generate", "metrics", "rouge", "sampling"]
