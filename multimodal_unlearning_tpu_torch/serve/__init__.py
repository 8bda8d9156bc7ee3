from multimodal_unlearning_tpu_torch.serve.engine import Request, ServingEngine
from multimodal_unlearning_tpu_torch.serve.http import EngineServer

__all__ = ["EngineServer", "Request", "ServingEngine"]
