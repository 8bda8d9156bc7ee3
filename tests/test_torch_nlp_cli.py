"""The text stack's training CLIs chained (CPU, f32): the port's
``cli/nlp_finetune`` -> ``cli/nlp_forget`` (RMU, LoRA) against the JAX
package's, on ``tiny-llama-test`` widened to 8 decoder layers (RMU reads
layer 7), one port-drawn base checkpoint, synthetic TOFU-style data, the same
global batch (the JAX side's ``batch_size`` is per device of the 8 CPU
devices of ``tests/conftest.py``), the same LoRA adapters (the port's
``init_model_lora`` replaced here by the JAX package's draw from
``PRNGKey(seed)``) and RMU's control vector from the JAX package's
``make_control_vec`` (the port draws its own from a ``torch.Generator``).
The port's forget run reads the JAX finetune's checkpoint, so that each
comparison is one stage's.  ``mesh`` axes above 1 raise in the finetune,
forget and eval CLIs.  The evaluation and aggregation CLIs:
``tests/test_torch_nlp_cli_eval.py``; the other losses:
``tests/test_torch_nlp_cli_losses.py``.

Tolerances: logged losses 1e-4 relative plus 1e-5 absolute, the saved
``model.safetensors`` 1e-5 absolute (same names and shapes)."""

from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import yaml
from safetensors.torch import load_file

from multimodal_unlearning_tpu.cli import nlp_finetune as jfinetune
from multimodal_unlearning_tpu.cli import nlp_forget as jforget
from multimodal_unlearning_tpu.config import load_config as jload
from multimodal_unlearning_tpu.config import registry as jregistry
from multimodal_unlearning_tpu.models import lora as jlora
from multimodal_unlearning_tpu.train import losses as jlosses
from multimodal_unlearning_tpu_torch.cli import common as tcommon
from multimodal_unlearning_tpu_torch.cli import nlp_eval as teval
from multimodal_unlearning_tpu_torch.cli import nlp_finetune as tfinetune
from multimodal_unlearning_tpu_torch.cli import nlp_forget as tforget
from multimodal_unlearning_tpu_torch.config import load_config as tload
from multimodal_unlearning_tpu_torch.config import registry as tregistry
from multimodal_unlearning_tpu_torch.models import convert
from multimodal_unlearning_tpu_torch.models import lora as tlora
from multimodal_unlearning_tpu_torch.train import losses as tlosses

CONFIGS = Path(__file__).resolve().parents[1] / "configs" / "nlp"
DATA = "synthetic:n_persons=20"  # 80 text rows, 8 forget rows
FAMILY = "model_family=tiny-llama-test"
N_DEV = 8  # the JAX side's CPU devices (tests/conftest.py)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def use_registry(mp, tmp, layers: int) -> None:
    """Both packages' registries with tiny-llama-test at ``layers`` decoder
    layers: the JAX package's read from a configs/ directory written here,
    the port's entry set in its ``PRESETS``."""
    reg = yaml.safe_load((tregistry.config_dir() / "model_config.yaml").read_text())
    reg["tiny-llama-test"]["arch"]["num_layers"] = layers
    d = tmp / "configs"
    d.mkdir(exist_ok=True)
    (d / "model_config.yaml").write_text(yaml.safe_dump(reg))
    mp.setattr(jregistry, "config_dir", lambda: d)
    mp.setitem(tregistry.PRESETS, "tiny-llama-test", reg["tiny-llama-test"])


def same_adapters(mp) -> None:
    """The port's LoRA adapters drawn as the JAX CLI draws its own."""
    def jax_adapters(model, r, generator, projector=True):
        del generator, projector
        layers = jax.tree.map(lambda t: t.numpy(), tcommon.model_tree(model)["layers"])
        tree = jlora.init_lora(layers, r, jax.random.PRNGKey(42))
        return convert.adapters_from_jax(jax.tree.map(np.asarray, tree), device="cpu")

    mp.setattr(tlora, "init_model_lora", jax_adapters)


def recorded(mp, module):
    """The JAX CLI's logged history (its ``run`` returns none)."""
    history = []
    real = module.train_loop

    def loop(**kw):
        state, h = real(**kw)
        history.extend(h)
        return state, h

    mp.setattr(module, "train_loop", loop)
    return history


def saved(path):
    return {k: v.numpy() for k, v in load_file(str(path / "model.safetensors")).items()}


def assert_same_model(got_dir, want_dir):
    got, want = saved(got_dir), saved(want_dir)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5, err_msg=k)


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    """Both packages' finetune and RMU forget runs, and their outputs."""
    tmp = tmp_path_factory.mktemp("nlp_chain")
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        use_registry(mp, tmp, layers=8)
        same_adapters(mp)
        # RMU's control vector: the JAX package's draw
        mp.setattr(tlosses, "make_control_vec", lambda gen, b, h: torch.from_numpy(np.array(
            jlosses.make_control_vec(jax.random.PRNGKey(42), b, h))))
        _, _, model = tcommon.init_or_load_params(tregistry.get_model_identifiers(
            "tiny-llama-test"), None, seed=0, device="cpu")
        tcommon.save_model(tmp / "base", tregistry.get_model_identifiers("tiny-llama-test"),
                           model)
        del model

        def both(name, jmod, tmod, args, config):
            jhist = recorded(mp, jmod)
            jmod.run(jload(CONFIGS, config, args + [
                "batch_size=1", f"save_dir={tmp / ('jax_' + name)}"]))
            thist = tmod.run(tload(CONFIGS, config, args + [
                f"batch_size={N_DEV}", "+device=cpu", f"save_dir={tmp / ('port_' + name)}"]))
            out[name] = dict(jax=jhist, port=thist, jax_dir=tmp / ("jax_" + name),
                             port_dir=tmp / ("port_" + name))

        # 80 rows, 16 a step: 3 steps (max_length 96 keeps every answer)
        common = [FAMILY, f"data_path={DATA}", "dtype=float32", "max_length=96", "LoRA.r=4",
                  "gradient_accumulation_steps=2", "lr=1e-3"]
        both("finetune", jfinetune, tfinetune,
             common + ["num_epochs=0.6", f"+model_path={tmp / 'base'}"], "finetune")
        # 8 forget rows, 8 a step: 3 steps (the first at the warmup's lr 0);
        # the port reads the JAX finetune's checkpoint
        both("forget", jforget, tforget,
             common[:-2] + ["gradient_accumulation_steps=1", "lr=1e-3", "forget_loss=RMU",
                            "num_epochs=3", f"model_path={tmp / 'jax_finetune'}"], "forget")
        yield out


def test_finetune_matches_jax(chain):
    run = chain["finetune"]
    assert [h["step"] for h in run["port"]] == [h["step"] for h in run["jax"]] == [1, 2, 3]
    tl, jl = [h["loss"] for h in run["port"]], [h["loss"] for h in run["jax"]]
    assert len(set(tl)) > 1
    np.testing.assert_allclose(tl, jl, rtol=1e-4, atol=1e-5)
    assert_same_model(run["port_dir"], run["jax_dir"])


def test_rmu_forget_matches_jax(chain):
    run = chain["forget"]
    assert [h["step"] for h in run["port"]] == [h["step"] for h in run["jax"]] == [1, 2, 3]
    tl, jl = [h["loss"] for h in run["port"]], [h["loss"] for h in run["jax"]]
    assert len(set(tl)) > 1
    np.testing.assert_allclose(tl, jl, rtol=1e-4, atol=1e-5)
    assert_same_model(run["port_dir"], run["jax_dir"])


@pytest.mark.parametrize("cli,config", [(tfinetune, "finetune"), (tforget, "forget"),
                                        (teval, "eval_everything")])
def test_mesh_above_one_raises(tmp_path, cli, config):
    cfg = tload(CONFIGS, config, [FAMILY, "mesh.tensor=2", "+device=cpu",
                                  f"save_dir={tmp_path}"])
    with pytest.raises(NotImplementedError, match="mesh"):
        cli.run(cfg)
