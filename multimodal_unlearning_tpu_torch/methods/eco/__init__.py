from multimodal_unlearning_tpu_torch.methods.eco.attacked_model import AttackedModel, get_eco_model
from multimodal_unlearning_tpu_torch.methods.eco.corrupt import corrupt_methods

__all__ = ["corrupt_methods", "AttackedModel", "get_eco_model"]
