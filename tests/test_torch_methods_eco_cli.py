"""ECO's entry points on the port against the JAX package's (CPU, f32,
``tiny-llama-test``): ``cli.eco_prepare`` end to end on one checkpoint
against the JAX CLI with its fault repaired (its ``generate`` handed the
tagged prompts the rows encode; ``tests/test_torch_methods_eco.py`` shows
the fault), rows equal, and the file it writes feeding the port's
``eco_ft`` forgetting; then the learned detectors: tiny BERTs trained by
the port's ``methods/eco/train_classifiers.py`` (a few epochs, on the host
CPU through ``transformers``) drive the port's ``AttackedModel`` as they
drive the JAX package's: the same gate, the same token pattern, the same
forward logits (within 1e-4)."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_unlearning_tpu.cli import common as jcommon
from multimodal_unlearning_tpu.cli import eco_prepare as jcli
from multimodal_unlearning_tpu.config import get_model_identifiers as jmodel_ids
from multimodal_unlearning_tpu.data.tokenizer import ByteTokenizer as JTok
from multimodal_unlearning_tpu.methods.eco import attacked_model as jam
from multimodal_unlearning_tpu_torch.cli import common as tcommon
from multimodal_unlearning_tpu_torch.cli import eco_prepare as tcli
from multimodal_unlearning_tpu_torch.cli import eco_train_classifiers as ttrain_cli
from multimodal_unlearning_tpu_torch.cli import nlp_forget as tforget
from multimodal_unlearning_tpu_torch.config import build_model_config, get_model_identifiers
from multimodal_unlearning_tpu_torch.data.nlp import TextForgetDatasetQA, resolve_text_rows
from multimodal_unlearning_tpu_torch.data.tokenizer import ByteTokenizer as TTok
from multimodal_unlearning_tpu_torch.evaluation.generate import pad_prompts
from multimodal_unlearning_tpu_torch.methods.eco import attacked_model as tam
from multimodal_unlearning_tpu_torch.methods.eco.prepare_prompts import tagged_prompts
from multimodal_unlearning_tpu_torch.models import llama as tllama

FAMILY = "tiny-llama-test"
DATA = "synthetic:n_persons=8"  # 32 text rows, 3 forget rows
TAGS = {"question_start_tag": "[INST] ", "question_end_tag": " [/INST]", "answer_tag": ""}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _model(seed):
    mcfg = build_model_config(get_model_identifiers(FAMILY))
    return tllama.init_params(mcfg, torch.Generator().manual_seed(seed), device="cpu")


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """One tiny-llama-test checkpoint both CLIs load."""
    d = tmp_path_factory.mktemp("eco_ckpt")
    tcommon.save_model(d, get_model_identifiers(FAMILY), _model(5))
    return d




def test_eco_prepare_cli_matches_jax(checkpoint, tmp_path, monkeypatch):
    """``cli.eco_prepare`` against the JAX CLI with its fault repaired (its
    ``generate`` given the tagged prompts the rows encode): the same rows;
    then the port's ``eco_ft`` forgetting reads the file."""
    args = [f"model_family={FAMILY}", f"data_path={DATA}", f"model_path={checkpoint}",
            "max_new_tokens=4", "batch_size=4"]
    got = tcli.main(args + [f"out_dir={tmp_path / 'port'}", "+device=cpu"])

    generate = jam.AttackedModel.generate

    def tagged_generate(self, ids, mask, *, prompts=None, **kw):
        return generate(self, ids, mask, prompts=tagged_prompts(prompts, TAGS), **kw)

    monkeypatch.setattr(jam.AttackedModel, "generate", tagged_generate)
    want = jcli.main(args + [f"out_dir={tmp_path / 'jax'}"])
    assert got == want and len(got) == 3
    lines = (tmp_path / "port" / "eco_prompts.jsonl").read_text().splitlines()
    assert [json.loads(line) for line in lines] == got
    assert all(set(r) == {"question", "answer"} for r in got)

    tok = TTok(256)
    ds = TextForgetDatasetQA(DATA, tok, TAGS, max_length=64, loss_type="eco_ft",
                             eco_prompts_path=str(tmp_path / "port"))
    assert [r["answer"] for r in ds.forget_rows] == [r["answer"] for r in got]
    history = tforget.main([f"model_family={FAMILY}", f"model_path={checkpoint}",
                            f"data_path={DATA}", "forget_loss=eco_ft",
                            f"eco_prompts_path={tmp_path / 'port'}", "batch_size=1",
                            "gradient_accumulation_steps=1", "num_epochs=1", "max_length=64",
                            "dtype=float32", "save_model=false",
                            f"save_dir={tmp_path / 'forget'}", "+device=cpu"])
    assert history and all(np.isfinite(h["loss"]) for h in history)


@pytest.fixture(scope="module")
def detectors(tmp_path_factory):
    """Prompt and token detectors trained by the port's CLI (a few epochs:
    the test is of the wiring, not of their quality)."""
    out = tmp_path_factory.mktemp("eco_detectors")
    p_dir, t_dir, metrics = ttrain_cli.main([f"data_path={DATA}", f"out_dir={out}", "epochs=3"])
    assert set(metrics) == {"prompt_classifier", "token_classifier", "holdout_frac"}
    assert json.loads((out / "metrics.json").read_text()) == metrics
    return p_dir, t_dir


def test_learned_detectors_drive_both_packages_alike(detectors):
    p_dir, t_dir = detectors
    rows = resolve_text_rows(DATA, "forget10")
    forget = [r["question"] for r in rows]
    retain = [r["question"] for r in resolve_text_rows(DATA, "retain90")[:2]]
    entities = sorted({r["name"] for r in rows})
    model = _model(0)
    jparams = jax.tree.map(lambda t: jnp.asarray(t.numpy()), tcommon.model_tree(model))
    kw = dict(prompt_classifier_path=p_dir, token_classifier_path=t_dir, dims=16,
              threshold=0.5)
    t = tam.get_eco_model(model, TTok(256), forget, entities, **kw)
    j = jam.get_eco_model(jparams, jcommon.build_model_config(jmodel_ids(FAMILY)), JTok(256),
                          forget, entities, **kw)
    assert type(t.prompt_classifier).__name__ == "HFPipelineBackend"
    prompts = tagged_prompts(forget + retain, TAGS)
    ids, mask = pad_prompts([TTok(256).encode(p, add_special_tokens=True) for p in prompts], 0,
                            multiple=16)
    assert np.array_equal(t._pattern(prompts, ids.shape[1]), j._pattern(prompts, ids.shape[1]))
    want = np.asarray(j(jnp.asarray(ids), attention_mask=jnp.asarray(mask),
                        prompts=prompts)["logits"])
    got = t(ids, attention_mask=mask, prompts=prompts)["logits"].numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)

