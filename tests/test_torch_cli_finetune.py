"""The finetune CLI end to end (CPU): the port's ``cli/mm_finetune.run``
against the JAX package's on one JAX-written checkpoint of
``tiny-llava-test``, synthetic CLEAR data (``full+tofu``: captions and QA),
the same global batch and the same LoRA adapters (the port's
``init_model_lora`` replaced here by the JAX package's draw from
``PRNGKey(seed)``): LoRA r 4 in f32 with gradient accumulation, 4 steps;
then the same at ``LoRA.r=0`` (the vision tower frozen, the model's own
parameters trained in place).

Tolerances: losses to 1e-4 relative plus 1e-5 absolute, the saved
``model.safetensors`` to 1e-5 absolute (same names and shapes), the config
snapshot the same dict (the port's also holds the ``device`` key).
"""

from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import yaml
from safetensors.torch import load_file

from multimodal_unlearning_tpu.cli import common as jcommon
from multimodal_unlearning_tpu.cli import mm_finetune as jfinetune
from multimodal_unlearning_tpu.config import load_config as jload
from multimodal_unlearning_tpu.config import registry as jregistry
from multimodal_unlearning_tpu.models import lora as jlora
from multimodal_unlearning_tpu_torch.cli import common as tcommon
from multimodal_unlearning_tpu_torch.cli import mm_finetune as tfinetune
from multimodal_unlearning_tpu_torch.config import load_config as tload
from multimodal_unlearning_tpu_torch.config import registry as tregistry
from multimodal_unlearning_tpu_torch.models import convert
from multimodal_unlearning_tpu_torch.models import lora as tlora


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for the port's small CPU tensors: under parallel
    test workers, torch's default of one thread per core oversubscribes the
    machine and its small ops slow down by orders of magnitude."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CONFIGS = Path(__file__).resolve().parents[1] / "configs" / "mm"
ARGS = ["model_family=tiny-llava-test", "data_path=synthetic:n_persons=10,qa_per_person=4",
        "split=full+tofu", "LoRA.alpha=16", "gradient_accumulation_steps=2",
        "dtype=float32", "max_length=128", "lr=1e-3",
        # 80 rows, 16 per step: 4 steps, no train-state save (5 steps an epoch)
        "num_epochs=0.8"]


def _run_both(tmp_path, monkeypatch, extra):
    model_cfg = tregistry.get_model_identifiers("tiny-llava-test")
    _, _, model = tcommon.init_or_load_params(model_cfg, None, seed=0, device="cpu")
    jparams = jax.tree.map(lambda t: t.numpy(), tcommon.model_tree(model))
    jcommon.save_model(tmp_path / "base", jregistry.get_model_identifiers("tiny-llava-test"),
                       jparams)

    def jax_adapters(model, r, generator, projector=True):
        del model, generator
        tree = jlora.init_model_lora(jparams, r, jax.random.PRNGKey(42), projector=projector)
        return convert.adapters_from_jax(jax.tree.map(np.asarray, tree), device="cpu")

    monkeypatch.setattr(tlora, "init_model_lora", jax_adapters)
    args = ARGS + [f"+model_path={tmp_path / 'base'}"] + extra
    # batch_size is per device: the JAX side runs on the 8 CPU devices of
    # tests/conftest.py, the port on one, with the same global batch
    n_dev = len(jax.devices())
    jhist = jfinetune.run(jload(CONFIGS, "finetune",
                                args + ["batch_size=1", f"save_dir={tmp_path / 'jax'}"]))
    thist = tfinetune.run(tload(CONFIGS, "finetune", args + [
        f"batch_size={n_dev}", "+device=cpu", f"save_dir={tmp_path / 'port'}"]))
    return jhist, thist


@pytest.mark.parametrize("extra", [["LoRA.r=4", "+save_adapters=true"], ["LoRA.r=0"]],
                         ids=["lora_r4", "full_r0"])
def test_finetune_cli_matches_jax(tmp_path, monkeypatch, extra):
    jhist, thist = _run_both(tmp_path, monkeypatch, extra)
    assert [h["step"] for h in thist] == [h["step"] for h in jhist] == [1, 2, 3, 4]
    jl, tl = [h["loss"] for h in jhist], [h["loss"] for h in thist]
    assert len(set(tl)) > 1
    np.testing.assert_allclose(tl, jl, rtol=1e-4, atol=1e-5)
    want = load_file(str(tmp_path / "jax" / "model.safetensors"))
    got = load_file(str(tmp_path / "port" / "model.safetensors"))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0, atol=1e-5,
                                   err_msg=k)
    jsnap = yaml.safe_load((tmp_path / "jax" / "config.yaml").read_text())
    tsnap = yaml.safe_load((tmp_path / "port" / "config.yaml").read_text())
    assert tsnap.pop("device") == "cpu"
    for key in ("save_dir", "batch_size"):
        jsnap.pop(key), tsnap.pop(key)
    assert tsnap == jsnap
    adapters = tmp_path / "port" / "adapter" / "adapter.safetensors"
    assert adapters.exists() == ("+save_adapters=true" in extra)
