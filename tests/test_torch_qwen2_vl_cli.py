"""The finetune and forget CLIs on Qwen2-VL end to end (CPU, f32,
``tiny-qwen2vl-test``), the port's against the JAX package's: finetune with
LoRA r 4 (the merger's adapters too; the JAX package's draw from
``PRNGKey(seed)`` injected into the port) from one base checkpoint, then
forget at ``LoRA.r=0`` (``grad_diff_forget_ce_retain_ce``, AdamW at the
config's lr, accumulation 2) from the JAX finetune's checkpoint; the same
global batch on both sides (the JAX CLI runs on the 8 virtual CPU devices
of ``tests/conftest.py`` with a per-device ``batch_size``).  Each package's
saved ``model.safetensors`` loads in the other's ``init_or_load_params``.

Tolerances: losses to 1e-4 relative plus 1e-5 absolute, the saved tensors
to 1e-5 absolute (same names and shapes), as the LLaVA CLI tests hold them;
a loaded checkpoint equal to the file exactly.
"""

from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from safetensors.torch import load_file

from multimodal_unlearning_tpu.cli import common as jcommon
from multimodal_unlearning_tpu.cli import mm_finetune as jfinetune
from multimodal_unlearning_tpu.cli import mm_forget as jforget
from multimodal_unlearning_tpu.config import load_config as jload
from multimodal_unlearning_tpu.config import registry as jregistry
from multimodal_unlearning_tpu.models import hf_bridge as jhf
from multimodal_unlearning_tpu.models import lora as jlora
from multimodal_unlearning_tpu_torch.cli import common as tcommon
from multimodal_unlearning_tpu_torch.cli import mm_finetune as tfinetune
from multimodal_unlearning_tpu_torch.cli import mm_forget as tforget
from multimodal_unlearning_tpu_torch.config import load_config as tload
from multimodal_unlearning_tpu_torch.config import registry as tregistry
from multimodal_unlearning_tpu_torch.models import convert
from multimodal_unlearning_tpu_torch.models import hf_bridge as thf
from multimodal_unlearning_tpu_torch.models import lora as tlora

FAMILY = "tiny-qwen2vl-test"
CONFIGS = Path(__file__).resolve().parents[1] / "configs" / "mm"
FT_ARGS = [f"model_family={FAMILY}", "data_path=synthetic:n_persons=10,qa_per_person=4",
           "split=full+tofu", "LoRA.r=4", "LoRA.alpha=16", "gradient_accumulation_steps=2",
           "dtype=float32", "max_length=128", "lr=1e-3",
           "num_epochs=0.4"]  # 80 rows, 16 a step: 2 steps, no train-state save
FG_DATA = "synthetic:n_persons=80,qa_per_person=4"
FG_ARGS = [f"model_family={FAMILY}", f"forget_data_path={FG_DATA}",
           f"retain_data_path={FG_DATA}", "gradient_accumulation_steps=2", "dtype=float32",
           "max_length=128",
           "num_epochs=0.5"]  # 64 forget rows, 16 a step: 2 steps, no train-state save


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _files_close(got_dir, want_dir):
    want = load_file(str(want_dir / "model.safetensors"))
    got = load_file(str(got_dir / "model.safetensors"))
    assert got.keys() == want.keys()
    assert any(k.startswith("visual.merger") for k in got)
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0, atol=1e-5, err_msg=k)
    return got, want


def _losses_close(thist, jhist, steps):
    assert [h["step"] for h in thist] == [h["step"] for h in jhist] == list(range(1, steps + 1))
    jl, tl = [h["loss"] for h in jhist], [h["loss"] for h in thist]
    assert len(set(tl)) > 1
    np.testing.assert_allclose(tl, jl, rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def finetuned(tmp_path_factory):
    """Both finetune CLIs from one base checkpoint (port-drawn, JAX-written)."""
    tmp = tmp_path_factory.mktemp("qwen_cli")
    _, _, model = tcommon.init_or_load_params(tregistry.get_model_identifiers(FAMILY), None,
                                              seed=0, device="cpu")
    jparams = jax.tree.map(lambda t: t.numpy(), tcommon.model_tree(model))
    jcommon.save_model(tmp / "base", jregistry.get_model_identifiers(FAMILY), jparams)

    def jax_adapters(model, r, generator, projector=True):
        del model, generator
        tree = jlora.init_model_lora(jparams, r, jax.random.PRNGKey(42), projector=projector)
        return convert.adapters_from_jax(jax.tree.map(np.asarray, tree), device="cpu")

    mp = pytest.MonkeyPatch()
    mp.setattr(tlora, "init_model_lora", jax_adapters)
    try:
        args = FT_ARGS + [f"+model_path={tmp / 'base'}"]
        jhist = jfinetune.run(jload(CONFIGS, "finetune", args + [
            "batch_size=1", f"save_dir={tmp / 'jax_ft'}"]))
        thist = tfinetune.run(tload(CONFIGS, "finetune", args + [
            f"batch_size={len(jax.devices())}", "+device=cpu", f"save_dir={tmp / 'port_ft'}"]))
    finally:
        mp.undo()
    return tmp, jhist, thist


def test_finetune_cli_matches_jax(finetuned):
    tmp, jhist, thist = finetuned
    _losses_close(thist, jhist, 2)
    got, _ = _files_close(tmp / "port_ft", tmp / "jax_ft")
    base = load_file(str(tmp / "base" / "model.safetensors"))
    # the merger's adapters moved its weights (merged into the saved file)
    assert not torch.equal(got["visual.merger.mlp.0.weight"], base["visual.merger.mlp.0.weight"])


def test_forget_cli_matches_jax(finetuned):
    tmp = finetuned[0]
    args = FG_ARGS + [f"model_path={tmp / 'jax_ft'}"]
    jhist = jforget.run(jload(CONFIGS, "forget", args + ["batch_size=1",
                                                        f"save_dir={tmp / 'jax_fg'}"]))
    thist = tforget.run(tload(CONFIGS, "forget", args + [
        f"batch_size={len(jax.devices())}", "+device=cpu", f"save_dir={tmp / 'port_fg'}"]))
    _losses_close(thist, jhist, 2)
    got, _ = _files_close(tmp / "port_fg", tmp / "jax_fg")
    ft = load_file(str(tmp / "jax_ft" / "model.safetensors"))
    # LoRA.r=0 trains the decoder and freezes the tower, the merger included
    assert not torch.equal(got["model.layers.0.self_attn.q_proj.bias"],
                           ft["model.layers.0.self_attn.q_proj.bias"])
    for k in ft:
        if k.startswith("visual."):
            assert torch.equal(got[k], ft[k]), k


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_saved_models_cross_both_ways(finetuned, writer):
    """A file either package saved loads in the other's
    ``init_or_load_params`` as the tensors in the file."""
    tmp = finetuned[0]
    path = tmp / f"{writer}_ft"
    want = load_file(str(path / "model.safetensors"))
    if writer == "port":
        _, _, params = jcommon.init_or_load_params(jregistry.get_model_identifiers(FAMILY),
                                                   str(path))
        got = {k: torch.from_numpy(np.array(v))
               for k, v in jhf.qwen2vl_to_hf(params).items()}
    else:
        _, _, model = tcommon.init_or_load_params(tregistry.get_model_identifiers(FAMILY),
                                                  str(path), device="cpu")
        got = thf.qwen2vl_to_hf(tcommon.model_tree(model))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(), err_msg=k)
