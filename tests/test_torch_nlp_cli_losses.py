"""The text stack's forget CLI by loss (CPU, f32): the port's
``cli/nlp_forget`` against the JAX package's on one port-drawn
``tiny-llama-test`` checkpoint, synthetic TOFU-style data and the same
global batch (the JAX side's ``batch_size`` is per device of the 8 CPU
devices of ``tests/conftest.py``): ``idk`` (one concatenated forward of the
idk and retain rows) and ``dpo`` (idk / forget / retain triplets) under LoRA
with the JAX package's adapters, and ``grad_proj`` (LoRA off, SGD, two
backward passes a step, the whole batch at once), three steps each, the
model saved.  RMU: ``tests/test_torch_nlp_cli.py``.

Tolerances: logged losses (``grad_proj``: the negative and positive losses
after each step) 1e-4 relative plus 1e-5 absolute, the saved
``model.safetensors`` 1e-5 absolute (same names and shapes)."""

import numpy as np
import pytest
import torch

from multimodal_unlearning_tpu.cli import nlp_forget as jforget
from multimodal_unlearning_tpu.config import load_config as jload
from multimodal_unlearning_tpu.train import grad_proj as jgp
from multimodal_unlearning_tpu_torch.cli import common as tcommon
from multimodal_unlearning_tpu_torch.cli import nlp_forget as tforget
from multimodal_unlearning_tpu_torch.config import load_config as tload
from multimodal_unlearning_tpu_torch.config import registry as tregistry
from tests.test_torch_nlp_cli import CONFIGS, N_DEV, assert_same_model, recorded, same_adapters


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def base(tmp_path_factory):
    d = tmp_path_factory.mktemp("nlp_losses") / "base"
    model_cfg = tregistry.get_model_identifiers("tiny-llama-test")
    _, _, model = tcommon.init_or_load_params(model_cfg, None, seed=0, device="cpu")
    tcommon.save_model(d, model_cfg, model)
    return d


def _grad_proj_history(monkeypatch):
    """Every step's losses of the JAX CLI's projection step."""
    history = []
    real = jgp.make_grad_proj_step

    def make(*a, **kw):
        step = real(*a, **kw)

        def recorded_step(*args):
            out = step(*args)
            history.append({"step": len(history) + 1, "neg_loss": float(out[2]["neg_loss"]),
                            "pos_loss": float(out[2]["pos_loss"])})
            return out
        return recorded_step

    monkeypatch.setattr(jgp, "make_grad_proj_step", make)
    return history


@pytest.mark.parametrize("loss", ["idk", "dpo", "grad_proj"])
def test_forget_loss_matches_jax(tmp_path, monkeypatch, base, loss):
    same_adapters(monkeypatch)
    if loss == "grad_proj":
        jhist = _grad_proj_history(monkeypatch)
        keys = ("neg_loss", "pos_loss")
    else:
        jhist = recorded(monkeypatch, jforget)
        keys = ("loss",)
    # 8 forget rows (of 80), 8 a step: 3 steps, the first of LoRA's at the
    # warmup's lr 0
    args = ["model_family=tiny-llama-test", "data_path=synthetic:n_persons=20",
            "dtype=float32", "max_length=96", "LoRA.r=4", "gradient_accumulation_steps=1",
            "lr=1e-3", "num_epochs=3", f"forget_loss={loss}", f"model_path={base}"]
    jforget.run(jload(CONFIGS, "forget", args + ["batch_size=1",
                                                 f"save_dir={tmp_path / 'jax'}"]))
    thist = tforget.run(tload(CONFIGS, "forget", args + [
        f"batch_size={N_DEV}", "+device=cpu", f"save_dir={tmp_path / 'port'}"]))
    assert [h["step"] for h in thist] == [h["step"] for h in jhist] == [1, 2, 3]
    for k in keys:
        tl, jl = [h[k] for h in thist], [h[k] for h in jhist]
        assert len(set(tl)) > 1, k
        np.testing.assert_allclose(tl, jl, rtol=1e-4, atol=1e-5, err_msg=k)
    assert_same_model(tmp_path / "port", tmp_path / "jax")
