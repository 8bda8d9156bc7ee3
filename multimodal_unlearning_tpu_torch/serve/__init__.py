from multimodal_unlearning_tpu_torch.serve.engine import Request, ServingEngine

__all__ = ["Request", "ServingEngine"]
