"""The forget CLI end to end (CPU): the port's ``cli/mm_forget.run`` against
the JAX package's on one JAX-written checkpoint, synthetic CLEAR data, the
same global batch and the same LoRA adapters (the port's ``init_model_lora`` replaced here by the
JAX package's draw from ``PRNGKey(seed)``), three steps of
``grad_diff_forget_ce_retain_ce`` with gradient accumulation; then the same
with an int8 base under W8A8 and the int8 dx backward (a 256-wide decoder:
the tiny presets are too narrow to quantize), full-parameter forgetting
(``LoRA.r=0``) with NPO and ``adamw_q8``, the same with the vision tower
trained (``freeze_vision_module=false``), LoRA over a grouped-int4 base
with NPO's teacher sharing it (``quantize_base=int4 quantize_teacher=int4``,
the 256-wide decoder) and L1 from the initial adapters;
a kill-and-resume run of the port; and the options the port has not
ported.

Tolerances.  f32 (every case but W8A8): losses to 1e-4 relative plus 1e-5 absolute (the loss is
the forget CE minus the retain CE, two terms of ~5.5 whose f32 roundoff,
~1e-6, does not shrink with their difference), saved tensors to 1e-5 absolute
(same names and shapes), the config snapshot the same dict (the port's also
holds the ``device`` key it was given).  W8A8: as in
``tests/test_torch_train_step.py`` -- activations and gradients are
re-quantized per row and a rounding can flip on float roundoff: losses to
3e-2 absolute, saved tensors to 1e-4 absolute (Adam moves an entry whose
gradient flipped sign by 2 lr = 2e-5 per step; the merge scales the
adapters' product by alpha / r = 8).  Resume: the resumed losses equal the
uninterrupted run's to 1e-6 relative.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml
from safetensors import safe_open
from safetensors.torch import load_file

from multimodal_unlearning_tpu.cli import common as jcommon
from multimodal_unlearning_tpu.cli import mm_forget as jforget
from multimodal_unlearning_tpu.config import load_config as jload
from multimodal_unlearning_tpu.config import registry as jregistry
from multimodal_unlearning_tpu.models import llama as jllama
from multimodal_unlearning_tpu.models import lora as jlora
from multimodal_unlearning_tpu.train import optim as joptim
from multimodal_unlearning_tpu.utils import quantize as jq
from multimodal_unlearning_tpu_torch.cli import common as tcommon
from multimodal_unlearning_tpu_torch.cli import mm_forget as tforget
from multimodal_unlearning_tpu_torch.config import load_config as tload
from multimodal_unlearning_tpu_torch.config import registry as tregistry
from multimodal_unlearning_tpu_torch.models import convert
from multimodal_unlearning_tpu_torch.models import llama as tllama
from multimodal_unlearning_tpu_torch.models import lora as tlora
from multimodal_unlearning_tpu_torch.train import checkpoints as tckpt
from multimodal_unlearning_tpu_torch.utils import quantize as tq

DATA = "synthetic:n_persons=40,qa_per_person=8"
BASE = [
    "model_family=tiny-llava-test", f"forget_data_path={DATA}", f"retain_data_path={DATA}", "forget_split=forget10+tofu",
    "retain_split=retain90+tofu", "forget_loss=grad_diff_forget_ce_retain_ce", "LoRA.r=4",
    "gradient_accumulation_steps=2", "dtype=float32", "max_length=128",
    # 64 rows, 16 per step: 3 steps
    "num_epochs=0.75",
]
FORGET_DIR = Path(__file__).resolve().parents[1] / "configs" / "mm"
WIDE = dict(vocab_size=512, hidden_size=256, intermediate_size=512, num_layers=2,
            num_heads=4, num_kv_heads=2)


def _registry(tmp_path, monkeypatch, wide: bool):
    """Both packages' registries with a tiny-llava-test entry that is 256
    wide (so that ``quantize_base`` quantizes it) when ``wide``: the JAX
    package's read from a configs/ directory written here, the port's
    entry set in its ``PRESETS``."""
    text = (tregistry.config_dir() / "model_config.yaml").read_text()
    reg = yaml.safe_load(text)
    if wide:
        arch = reg["tiny-llava-test"]["arch"]
        arch["decoder"].update(WIDE)
        arch["image_token_id"] = 500
    d = tmp_path / "configs"
    d.mkdir()
    (d / "model_config.yaml").write_text(yaml.safe_dump(reg))
    monkeypatch.setattr(jregistry, "config_dir", lambda: d)
    monkeypatch.setitem(tregistry.PRESETS, "tiny-llava-test", reg["tiny-llava-test"])


@pytest.fixture
def flags_off():
    yield
    jllama.enable_int8_compute(False)
    jq.enable_int8_bwd(False)


def _q8_uint8_v(monkeypatch):
    """The JAX package's ``adamw_q8`` starts its second moment as int8 zeros
    and writes uint8 after the first update; under the train step's
    non-finite guard ``jnp.where(ok, new, old)`` promotes the pair to int16,
    and from the second step on ``_dequantize`` reads the quartic-root codes
    as linear ones (``ROADMAP.md`` queue 2).  The reference here starts that
    moment as uint8 zeros, the same values, so that it keeps its dtype."""
    real = joptim.adamw_q8

    def adamw_q8(*a, **kw):
        tx = real(*a, **kw)

        def init(params):
            st = tx.init(params)
            is_q = lambda x: isinstance(x, tuple) and hasattr(x, "scale")
            return st._replace(v=jax.tree.map(lambda m: m._replace(q=m.q.astype(jnp.uint8)),
                                              st.v, is_leaf=is_q))
        return optax.GradientTransformation(init, tx.update)

    monkeypatch.setattr(joptim, "adamw_q8", adamw_q8)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The base checkpoint of each width, drawn and written once per module
    and read by every case's JAX and port runs."""
    return {"dir": tmp_path_factory.mktemp("bases"), "bases": {}}


def _parity(tmp_path, monkeypatch, extra, reference, wide=False):
    _registry(tmp_path, monkeypatch, wide=wide)
    _q8_uint8_v(monkeypatch)
    # the JAX package writes the base checkpoint; its weights are drawn by the
    # port (a JAX init would cost a compile per leaf)
    base = reference["dir"] / ("wide" if wide else "narrow")
    if base not in reference["bases"]:
        _, _, model = tcommon.init_or_load_params(
            tregistry.get_model_identifiers("tiny-llava-test"), None, seed=0, device="cpu")
        reference["bases"][base] = jax.tree.map(lambda t: t.numpy(), tcommon.model_tree(model))
        jcommon.save_model(base, jregistry.get_model_identifiers("tiny-llava-test"),
                           reference["bases"][base])
    jparams = reference["bases"][base]

    def jax_adapters(model, r, generator, projector=True):
        del model, generator
        tree = jlora.init_model_lora(jparams, r, jax.random.PRNGKey(42), projector=projector)
        return convert.adapters_from_jax(jax.tree.map(np.asarray, tree), device="cpu")

    monkeypatch.setattr(tlora, "init_model_lora", jax_adapters)
    args = BASE + [f"model_path={base}"] + extra
    # batch_size is per device: the JAX side runs on the 8 CPU devices of
    # tests/conftest.py (mesh data=-1), the port on one, with the same
    # global batch of 2 micro-batches of 8 rows
    n_dev = len(jax.devices())
    jcfg = jload(FORGET_DIR, "forget", args + ["batch_size=1", f"save_dir={tmp_path / 'jax'}"])
    tcfg = tload(FORGET_DIR, "forget", args + [f"batch_size={n_dev}", "+device=cpu",
                                               f"save_dir={tmp_path / 'port'}"])
    jhist = jforget.run(jcfg)
    thist = tforget.run(tcfg)
    return jhist, thist


def _saved(path):
    return {k: v.numpy() for k, v in load_file(str(path / "model.safetensors")).items()}


CASES = {
    "f32": [],
    "w8a8": ["quantize_base=true", "int8_compute=true", "int8_bwd=true"],
    # full-parameter forgetting (the vision tower frozen) with NPO's teacher
    # and int8 blockwise Adam moments
    "r0_npo_q8": ["LoRA.r=0", "forget_loss=npo", "optimizer=adamw_q8"],
    # L1 of the adapters' distance from their initial values, under LoRA
    "lora_l1_init": ["l1_lambda=0.1", "l_norm_from=init"],
    # full-parameter forgetting with the vision tower trained too
    "r0_vision": ["LoRA.r=0", "freeze_vision_module=false"],
    # QLoRA: adapters over a grouped-int4 base (the 256-wide decoder), NPO's
    # teacher the same int4 base (quantize_teacher=int4 shares it)
    "qlora_int4": ["quantize_base=int4", "forget_loss=npo", "quantize_teacher=int4"],
}


@pytest.mark.parametrize("case", list(CASES))
def test_forget_cli_matches_jax(tmp_path, monkeypatch, flags_off, reference, case):
    extra = CASES[case]
    jhist, thist = _parity(tmp_path, monkeypatch, extra, reference,
                           wide=case in ("w8a8", "qlora_int4"))
    assert [h["step"] for h in thist] == [h["step"] for h in jhist] == [1, 2, 3]
    jl, tl = [h["loss"] for h in jhist], [h["loss"] for h in thist]
    if case != "w8a8":
        np.testing.assert_allclose(tl, jl, rtol=1e-4, atol=1e-5)
    else:
        np.testing.assert_allclose(tl, jl, atol=3e-2, rtol=0)
        # run() turns the int8 switches off again
        assert not tllama.INT8_COMPUTE and not tq.INT8_BWD
    want, got = _saved(tmp_path / "jax"), _saved(tmp_path / "port")
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k], want[k], rtol=0,
                                   atol=1e-4 if case == "w8a8" else 1e-5, err_msg=k)
    jsnap = yaml.safe_load((tmp_path / "jax" / "config.yaml").read_text())
    tsnap = yaml.safe_load((tmp_path / "port" / "config.yaml").read_text())
    assert tsnap.pop("device") == "cpu"
    for key in ("save_dir", "batch_size"):
        jsnap.pop(key), tsnap.pop(key)
    assert tsnap == jsnap


def _resume_cfg(tmp_path, out, **extra):
    args = ["model_family=tiny-llava-test", "model_path=null",
            "forget_data_path=synthetic:n_persons=10,qa_per_person=4",
            "retain_data_path=synthetic:n_persons=10,qa_per_person=4", "forget_loss=grad_ascent",
            "LoRA.r=4", "lr=1e-3", "batch_size=2", "gradient_accumulation_steps=1",
            "num_epochs=2", "max_length=128", "dtype=float32", "save_model=false",
            f"save_dir={tmp_path / out}", "+device=cpu"]
    args += [f"+{k}={v}" for k, v in extra.items()]
    return tload(FORGET_DIR, "forget", args)


def test_forget_cli_kill_and_resume(tmp_path, monkeypatch):
    """Kill a run right after its epoch train-state checkpoint, resume with
    resume_from_checkpoint=true: the resumed losses equal the uninterrupted
    run's (batch-skip replay, restored moments)."""
    full = tforget.run(_resume_cfg(tmp_path, "full"))
    assert len(full) == 8
    real_save = tckpt.TrainStateCheckpointer.save

    def save_once_then_die(self, step, state):
        real_save(self, step, state)
        self.wait()  # the write lands before the "preemption"
        raise KeyboardInterrupt("preempted right after the epoch checkpoint")

    monkeypatch.setattr(tckpt.TrainStateCheckpointer, "save", save_once_then_die)
    with pytest.raises(KeyboardInterrupt):
        tforget.run(_resume_cfg(tmp_path, "pre"))
    monkeypatch.undo()
    step = tckpt.latest_train_state_step(tmp_path / "pre" / "train_state")
    assert step == 4
    resumed = tforget.run(_resume_cfg(tmp_path, "pre", resume_from_checkpoint=True))
    res, ful = {h["step"]: h["loss"] for h in resumed}, {h["step"]: h["loss"] for h in full}
    assert min(res) == step + 1 and max(res) == 8
    for s in res:
        np.testing.assert_allclose(res[s], ful[s], rtol=1e-6)


def test_checkpoints_keep_merge_dtype(tmp_path):
    """Per-epoch model checkpoints (``save_ckpts``) are merged in
    ``merge_dtype`` like the final model, on a dense f32 base too; the raw
    adapters are saved beside them."""
    cfg = _resume_cfg(tmp_path, "out", save_ckpts=True, save_adapters=True)
    for key, val in (("save_model", True), ("merge_dtype", "bfloat16")):
        dict.__setitem__(cfg, key, val)
    tforget.run(cfg)
    for path in (tmp_path / "out", tmp_path / "out" / "checkpoint-4"):
        with safe_open(str(path / "model.safetensors"), framework="pt") as f:
            assert {f.get_tensor(k).dtype for k in f.keys()} == {torch.bfloat16}, path
    tree, scale = tckpt.load_adapter(tmp_path / "out" / "adapter")
    assert scale == 32 / 4 and tree["language_model"]["layers"]["q_proj"]["a"].shape[-1] == 4


@pytest.mark.parametrize("override", ["mesh.tensor=2", "merge_dtype=bf16"])
def test_unported_options_raise(tmp_path, override):
    cfg = tload(FORGET_DIR, "forget", [
        "model_family=tiny-llava-test", "model_path=null", "LoRA.r=4", "forget_data_path=synthetic",
        "retain_data_path=synthetic", f"save_dir={tmp_path / 'out'}", "+device=cpu",
        *override.split()])
    # merge_dtype is checked when the config is read: an unknown name is a
    # ValueError listing the accepted ones, before any work is done
    if override.startswith("merge_dtype"):
        with pytest.raises(ValueError, match="accepted values are bfloat16"):
            tforget.run(cfg)
    else:
        with pytest.raises(NotImplementedError):
            tforget.run(cfg)
    assert not (tmp_path / "out").exists()
