"""ECO on the port (``methods/eco``, ``cli/eco_prepare``) against the JAX
package's (CPU, f32, ``tiny-llama-test``, inputs from numpy with a seed):

- every corruption operation with the same key: the deterministic ones and
  the permutations exactly, the normal noise to 1e-6 (the port draws it
  through XLA's erfinv polynomial; ``log1p`` and the products may round
  their last bits otherwise);
- the corpus classifiers' gate and token labels, equal;
- ``AttackedModel``'s forward logits within 1e-4 (two f32 computations of a
  2-layer decoder), ``generate``'s tokens equal;
- the JAX package's fault: its ``prepare_eco_prompts`` labels the bare
  question and right-aligns the labels to the tagged row, so it flags
  ``"0? [/INST"``; the port flags the entity ``"Person000"``.

The CLI and the learned detectors: ``tests/test_torch_methods_eco_cli.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_unlearning_tpu.cli import common as jcommon
from multimodal_unlearning_tpu.config import get_model_identifiers as jmodel_ids
from multimodal_unlearning_tpu.data.tokenizer import ByteTokenizer as JTok
from multimodal_unlearning_tpu.evaluation.generate import pad_prompts as jpad
from multimodal_unlearning_tpu.methods.eco import attacked_model as jam
from multimodal_unlearning_tpu.methods.eco import classifier as jclf
from multimodal_unlearning_tpu.methods.eco import corrupt as jc
from multimodal_unlearning_tpu_torch.cli import common as tcommon
from multimodal_unlearning_tpu_torch.config import build_model_config, get_model_identifiers
from multimodal_unlearning_tpu_torch.data.nlp import resolve_text_rows
from multimodal_unlearning_tpu_torch.data.tokenizer import ByteTokenizer as TTok
from multimodal_unlearning_tpu_torch.evaluation.generate import pad_prompts as tpad
from multimodal_unlearning_tpu_torch.methods.eco import attacked_model as tam
from multimodal_unlearning_tpu_torch.methods.eco import classifier as tclf
from multimodal_unlearning_tpu_torch.methods.eco import corrupt as tc
from multimodal_unlearning_tpu_torch.methods.eco.prepare_prompts import tagged_prompts
from multimodal_unlearning_tpu_torch.models import llama as tllama

FAMILY = "tiny-llama-test"
DATA = "synthetic:n_persons=8"  # 32 text rows, 3 forget rows
TAGS = {"question_start_tag": "[INST] ", "question_end_tag": " [/INST]", "answer_tag": ""}
NOISE_TOL = 1e-6
NOISY = {"rand_noise_first_n", "rand_noise_top_k", "set_rand_noise_first_n",
         "rand_noise_rand_n"}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("n", [10, 577, 4096])
def test_keys_and_permutation_match_jax(n):
    """``split`` and ``permutation`` bit for bit (4,096: two sorting rounds),
    the normal noise to 1e-6."""
    k = jax.random.PRNGKey(n)
    tk = tc.prng_key(n)
    assert np.array_equal(np.asarray(jax.random.split(k)).astype(np.int64),
                          torch.stack(tc.split(tk)).numpy())
    assert np.array_equal(np.asarray(jax.random.permutation(k, n)), tc.permutation(tk, n).numpy())
    want = np.asarray(jax.random.normal(k, (3, n), jnp.float32))
    np.testing.assert_allclose(tc.normal(tk, (3, n)).numpy(), want, atol=NOISE_TOL, rtol=0)


@pytest.mark.parametrize("name", sorted(tc.corrupt_methods))
def test_corruption_ops_match_jax(name):
    """Each operation on [2, 9, 64] embeddings with ties at the k-th value
    (``_topk_mask``'s ``>=`` keeps them all), the same key on both sides."""
    rng = np.random.default_rng(len(name))
    data = rng.standard_normal((2, 9, 64)).astype(np.float32)
    data[0, 3, :30] = 0.5                      # ties at the 20th largest value
    pos = (rng.random((2, 9)) > 0.4).astype(np.int32)
    pos[1] = 0                                 # a row that is not attacked
    kw = dict(dims=20, strength=0.7)
    want = np.asarray(jc.corrupt_methods[name](jnp.asarray(data), jnp.asarray(pos),
                                               key=jax.random.PRNGKey(3), **kw))
    got = tc.corrupt_methods[name](torch.from_numpy(data), torch.from_numpy(pos),
                                   key=tc.prng_key(3), **kw).numpy()
    if name in NOISY:
        np.testing.assert_allclose(got, want, atol=NOISE_TOL, rtol=0)
    else:
        assert np.array_equal(got, want)


def _entities_and_questions():
    rows = resolve_text_rows(DATA, "forget10")
    retain = resolve_text_rows(DATA, "retain90")
    entities = sorted({r["name"] for r in rows})
    return entities, [r["question"] for r in rows], [r["question"] for r in retain[:3]]


def test_classifiers_match_jax():
    """Gate scores and decisions on forget, retain and tagged prompts, and
    the token labels in the byte tokenizer's space, equal to JAX's."""
    entities, forget, retain = _entities_and_questions()
    prompts = forget + retain + tagged_prompts(forget + retain, TAGS) + ["", "What is 2+2?"]
    jp, tp = jclf.CorpusPromptClassifier(forget, entities), tclf.CorpusPromptClassifier(
        forget, entities)
    for thr in (0.5, 0.999):
        assert tp.predict(prompts, threshold=thr) == jp.predict(prompts, threshold=thr)
    assert [tp.score(p) for p in prompts] == [jp.score(p) for p in prompts]
    jt, tt = jclf.CorpusTokenClassifier(entities), tclf.CorpusTokenClassifier(entities)
    assert (tt.predict_target_token_labels(prompts, TTok(256))
            == jt.predict_target_token_labels(prompts, JTok(256)))


def _models(seed=0):
    mcfg = build_model_config(get_model_identifiers(FAMILY))
    model = tllama.init_params(mcfg, torch.Generator().manual_seed(seed), device="cpu")
    jparams = jax.tree.map(lambda t: jnp.asarray(t.numpy()), tcommon.model_tree(model))
    jcfg = jcommon.build_model_config(jmodel_ids(FAMILY))
    return model, jparams, jcfg


def _attacked(model, jparams, jcfg, method="zero_out_top_k", dims=16):
    entities, forget, _ = _entities_and_questions()
    j = jam.AttackedModel(jparams, jcfg, JTok(256), jclf.CorpusPromptClassifier(forget, entities),
                          jclf.CorpusTokenClassifier(entities), corrupt_method=method,
                          corrupt_args={"dims": dims, **({"strength": 0.5} if method in NOISY
                                                         else {})})
    t = tam.AttackedModel(model, TTok(256), tclf.CorpusPromptClassifier(forget, entities),
                          tclf.CorpusTokenClassifier(entities), corrupt_method=method,
                          corrupt_args=dict(j.corrupt_args))
    return j, t


def _batch(prompts):
    enc = [TTok(256).encode(p, add_special_tokens=True) for p in prompts]
    ids, mask = tpad(enc, 0, multiple=16)
    jids, jmask = jpad(enc, 0, multiple=16)
    assert np.array_equal(ids, jids) and np.array_equal(mask, jmask)
    return ids, mask


@pytest.mark.parametrize("method", ["zero_out_top_k", "rand_noise_first_n"])
def test_attacked_model_matches_jax(method):
    """Forward logits within 1e-4 on a gated and an ungated row (two calls:
    the key advances on both sides alike); greedy tokens equal (the noisy
    operation's tokens: the CLI's test runs the default one)."""
    model, jparams, jcfg = _models()
    j, t = _attacked(model, jparams, jcfg, method)
    _, forget, retain = _entities_and_questions()
    prompts = tagged_prompts([forget[0], retain[0]], TAGS)
    ids, mask = _batch(prompts)
    for _ in range(2):
        want = np.asarray(j(jnp.asarray(ids), attention_mask=jnp.asarray(mask),
                            prompts=prompts)["logits"])
        got = t(ids, attention_mask=mask, prompts=prompts)["logits"].numpy()
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    if method in NOISY:
        want = j.generate(ids, mask, max_new_tokens=4, prompts=prompts)
        got = t.generate(ids, mask, max_new_tokens=4, prompts=prompts)
        assert np.array_equal(got, np.asarray(want))


def _flagged(pattern, ids):
    return TTok(256).decode(ids[pattern.astype(bool)])


def test_eco_labels_land_on_the_entity():
    """The JAX package's ``prepare_eco_prompts`` passes the bare question as
    ``prompts`` to a row that encodes the tagged one: the labels land
    ``len(" [/INST]")`` tokens to the right.  The port labels the tagged
    prompt and flags exactly the entity."""
    model, jparams, jcfg = _models()
    j, t = _attacked(model, jparams, jcfg)
    _, forget, _ = _entities_and_questions()
    prompts = tagged_prompts(forget[:1], TAGS)
    ids, _ = _batch(prompts)
    jax_flags = _flagged(j._pattern(forget[:1], ids.shape[1])[0], ids[0])
    port_flags = _flagged(t._pattern(prompts, ids.shape[1], gate_prompts=forget[:1])[0], ids[0])
    assert forget[0] == "What is fact 0 about Person000?"
    assert jax_flags == "0? [/INST"
    assert port_flags == "Person000"
