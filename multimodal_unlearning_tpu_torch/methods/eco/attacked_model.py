"""ECO's attacked model: the port's counterpart of
``multimodal_unlearning_tpu/methods/eco/attacked_model.py`` (reference:
methods/eco/attk_model.py:38-128).

Composes a decoder (the port's ``models.llama.Llama``) with the prompt and
token classifiers: on every call or generate, classify the prompts, build a
per-token corruption pattern, and corrupt the embedding activations of the
flagged tokens before the decoder runs (the reference's forward hook on
``embed_tokens`` is exactly that transform: the embeddings are computed,
corrupted and passed as ``inputs_embeds``).

The model computes in f32 by default, as in the JAX package.  On the card
an f32 prefill and the cache-less forward run B1's f32 instance
(``ops/csrc/flash_fwd_f32.cu``) and each decode step the one-token kernel's
f32 instance (``ops/csrc/flash_decode.cu``), where the JAX package reached
its Pallas kernels at f32.  Unlike the JAX package, the cache holds exactly
the prompt and the new tokens (no rounding of its length to a multiple of
128, a TPU alignment), and the decode steps read only the columns written
so far; the tokens are the same.

``prompts`` labels the tokens: they must be the text that ``input_ids``
encode (the tagged prompts), so that the labels, right-aligned to the
row, land on the tokens they name.  ``gate_prompts`` (default: ``prompts``)
is what the prompt classifier judges, such as the bare questions.
"""

from __future__ import annotations

import numpy as np
import torch

from multimodal_unlearning_tpu_torch.methods.eco.classifier import (
    CorpusPromptClassifier, CorpusTokenClassifier)
from multimodal_unlearning_tpu_torch.methods.eco.corrupt import corrupt_methods, prng_key, split
from multimodal_unlearning_tpu_torch.models import llama
from multimodal_unlearning_tpu_torch.utils.quantize import embed_lookup, is_qtensor

__all__ = ["AttackedModel", "get_eco_model"]


class AttackedModel:
    def __init__(self, model, tokenizer, prompt_classifier, token_classifier, *,
                 corrupt_method: str = "zero_out_top_k", corrupt_args: dict | None = None,
                 threshold: float = 0.999, compute_dtype=torch.float32, seed: int = 0):
        self.model = model
        self.model_cfg = model.cfg
        self.tokenizer = tokenizer
        self.prompt_classifier = prompt_classifier
        self.token_classifier = token_classifier
        self.corrupt_fn = corrupt_methods[corrupt_method]
        self.corrupt_args = corrupt_args or {}
        self.threshold = threshold
        self.compute_dtype = compute_dtype
        self.device = model.norm.device
        self.key = prng_key(seed, self.device)

    def _pattern(self, prompts: list[str], S: int, gate_prompts=None) -> np.ndarray:
        """[B, S] attack mask: prompt gate x token labels (attk_model.py:69-88),
        the labels right-aligned to the row."""
        gate = self.prompt_classifier.predict(gate_prompts or prompts, threshold=self.threshold)
        token_labels = self.token_classifier.predict_target_token_labels(prompts, self.tokenizer)
        pat = np.zeros((len(prompts), S), np.int32)
        for r, (g, labels) in enumerate(zip(gate, token_labels)):
            if not g:
                continue
            lab = labels[-S:] if len(labels) >= S else [0] * (S - len(labels)) + labels
            pat[r] = lab
        return pat

    def _ids(self, x):
        x = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))
        return x.to(self.device).long()

    def _prompts(self, input_ids, prompts):
        return prompts or [self.tokenizer.decode(r, skip_special_tokens=True)
                           for r in input_ids.tolist()]

    def corrupted_embeds(self, input_ids, prompts, gate_prompts=None):
        et = self.model.embed_tokens
        embeds = (embed_lookup(et, input_ids) if is_qtensor(et) else et[input_ids]).to(
            self.compute_dtype)
        pat = torch.from_numpy(self._pattern(prompts, input_ids.shape[1], gate_prompts)).to(
            self.device)
        self.key, sub = split(self.key)
        return self.corrupt_fn(embeds, pat, key=sub, **self.corrupt_args)

    @torch.no_grad()
    def __call__(self, input_ids, attention_mask=None, labels=None, prompts=None,
                 gate_prompts=None, **kw):
        """Forward with corruption (kwargs ``prompts``/``answers`` accepted and
        stripped, like methods/eco/model.py:60-75)."""
        kw.pop("answers", None)
        input_ids = self._ids(input_ids)
        prompts = self._prompts(input_ids, prompts)
        embeds = self.corrupted_embeds(input_ids, prompts, gate_prompts)
        return self.model.forward(
            inputs_embeds=embeds,
            attention_mask=None if attention_mask is None else self._ids(attention_mask),
            compute_dtype=self.compute_dtype)

    @torch.no_grad()
    def generate(self, input_ids, attention_mask, *, max_new_tokens: int, prompts=None,
                 gate_prompts=None, **kw):
        """Greedy generation from corrupted prompt embeddings: the corrupted
        prefill fills the KV cache; decode proceeds normally.  Returns
        [B, max_new_tokens] int64 numpy ids, pad after an eos."""
        kw.pop("answers", None)
        input_ids, attention_mask = self._ids(input_ids), self._ids(attention_mask)
        B, S = input_ids.shape
        prompts = self._prompts(input_ids, prompts)
        embeds = self.corrupted_embeds(input_ids, prompts, gate_prompts)

        smax = S + max_new_tokens
        cache = llama.init_kv_cache(self.model_cfg, B, smax, dtype=self.compute_dtype,
                                    device=self.device)
        kv_valid = torch.zeros((B, smax), dtype=torch.int32, device=self.device)
        kv_valid[:, :S] = attention_mask
        fwd = dict(compute_dtype=self.compute_dtype, last_logit_only=True)
        out = self.model.forward(inputs_embeds=embeds, attention_mask=attention_mask,
                                 kv_cache=cache, cache_offset=0, kv_valid_mask=kv_valid, **fwd)
        tok = torch.argmax(out["logits"][:, -1, :], dim=-1)
        prompt_len = attention_mask.sum(dim=-1)
        tokens = [tok]
        finished = torch.zeros(B, dtype=torch.bool, device=self.device)
        ones = torch.ones((B, 1), dtype=torch.int32, device=self.device)
        eos, pad = self.tokenizer.eos_token_id, self.tokenizer.pad_token_id
        for t in range(max_new_tokens - 1):
            kv_valid[:, S + t] = 1
            out = self.model.forward(tok[:, None], attention_mask=ones,
                                     positions=(prompt_len + t)[:, None], kv_cache=cache,
                                     cache_offset=S + t, kv_valid_mask=kv_valid[:, :S + t + 1],
                                     **fwd)
            tok = torch.argmax(out["logits"][:, -1, :], dim=-1)
            finished |= tok == eos
            tokens.append(torch.where(finished, pad, tok))
        return torch.stack(tokens, dim=1).cpu().numpy()


def get_eco_model(model, tokenizer, forget_prompts, entities, *,
                  corrupt_method="zero_out_top_k", dims=1000, threshold=0.999,
                  compute_dtype=torch.float32, prompt_classifier_path: str | None = None,
                  token_classifier_path: str | None = None):
    """llama_setup defaults (methods/eco/main.py:6-45): zero_out_top_k,
    dims=1000, prompt threshold .999.

    With ``prompt_classifier_path``/``token_classifier_path`` the detectors
    are the learned HF pipeline models (train them with
    ``methods/eco/train_classifiers.py``); otherwise the corpus heuristics."""
    from multimodal_unlearning_tpu_torch.methods.eco.classifier import (
        HFPipelineBackend, HFTokenPipelineBackend)

    dims = min(dims, model.cfg.hidden_size)
    prompt_clf = (HFPipelineBackend(prompt_classifier_path) if prompt_classifier_path
                  else CorpusPromptClassifier(forget_prompts, entities))
    token_clf = (HFTokenPipelineBackend(token_classifier_path) if token_classifier_path
                 else CorpusTokenClassifier(entities))
    return AttackedModel(model, tokenizer, prompt_clf, token_clf,
                         corrupt_method=corrupt_method, corrupt_args={"dims": dims},
                         threshold=threshold, compute_dtype=compute_dtype)
