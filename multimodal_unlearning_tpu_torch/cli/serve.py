"""Offline serving entry point of the PyTorch port.

Drains a JSONL request file through the continuous-batching engine
(serve/engine.py) and writes one completion per line, like
``multimodal_unlearning_tpu/cli/serve.py``.  Request lines:
{"question": str, "image": optional path or null, "max_new_tokens":
optional int, "stop": optional string or list of strings, "draft":
optional expected-answer text seeding the speculative lookup, "adapter":
optional name of one of ``adapters``, "sample_seed": optional int}.

  python -m multimodal_unlearning_tpu_torch.cli.serve \\
      model_family=llava requests=reqs.jsonl save_file=out.jsonl

``model_family=qwen-vl2-2b`` (or ``qwen-vl-3b``, the windowed 2.5 tower)
serves Qwen2-VL: a request's image becomes the tower's patches and the
engine carries its M-RoPE positions.

As ``configs/mm/serve.yaml`` ships it, the decoder is int8 (W8A16,
``quantize_base=true``); ``quantize_base=int4`` (or ``int4:g64``, groups of
64 rows) serves a grouped-int4 decoder (W4A16, kernel B8, bf16 activations)
and ``quantize_base=false`` bf16 weights.  ``kv_cache_dtype=int8`` quantizes
the KV cache, ``speculative_k=4`` verifies prompt-lookup drafts,
``prefill_chunk=512`` prefills long prompts in chunks and
``system_prompt=...`` prefills a shared prefix once (text requests prefill
only their own suffix against it).  ``temperature=0.7 top_k=50 top_p=0.9``
samples (a request's stream from its ``sample_seed``, by default its
position in the file counted from 1); ``logprobs=true`` writes each
completion's per-token logprobs (``"logprobs"``, rounded to 6 places);
``'adapters={ft: dir1, npo: dir2}'`` serves LoRA adapters saved by
``train/checkpoints.save_adapter`` (the forget and finetune CLIs'
``adapter`` directories) from one engine, each request on the adapter it
names (none: the base model).
``page_size=128`` pages the KV cache (``kv_pool_pages=N`` caps the pool;
0 keeps the dense layout's capacity): the summary line then reports the
pool's peak pages and preemptions.

Overrides are ``key=value`` (dotted keys reach nested ones, e.g.
``generation.max_new_tokens=64``) onto ``configs/mm/serve.yaml``, read as
every entry point of the port reads its file (``config/loader.py``).
``model_path`` names a checkpoint directory (an HF-layout
``model.safetensors``, e.g. what ``cli/mm_forget.py`` saves, or a quantized
checkpoint), loaded straight to the device in ``dtype`` and then quantized
as ``quantize_base`` asks; without one the weights are random, drawn from
``seed``.  The tokenizer is the byte tokenizer: as in the JAX package, a
``processor_path`` (by default ``model_path``) is read only where it holds
``tokenizer*`` files, and those need ``transformers``: that raises.
``device`` picks the device: the card unless ``device=cpu``.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

from multimodal_unlearning_tpu_torch.cli.common import (
    build_processor, dtype_of, init_or_load_params, quantize_base_params)
from multimodal_unlearning_tpu_torch.config import (
    Config, build_model_config, config_dir, get_model_identifiers, loader, model_kind)
from multimodal_unlearning_tpu_torch.device import resolve_device
from multimodal_unlearning_tpu_torch.models import VLM_KINDS
from multimodal_unlearning_tpu_torch.serve import ServingEngine
from multimodal_unlearning_tpu_torch.train.checkpoints import load_adapter
from multimodal_unlearning_tpu_torch.utils.quantize import tree_nbytes


def load_config(argv=None) -> Config:
    """``configs/mm/serve.yaml`` with ``key=value`` overrides (``sys.argv``
    unless ``argv`` is given), read as ``cli/mm_forget.py`` reads its file;
    unknown keys raise.  ``device``, the port's own key, is there too,
    null (the card) unless overridden."""
    cfg = loader.load_config(config_dir() / "mm", "serve")
    dict.setdefault(cfg, "device", None)
    return loader.apply_overrides(cfg, list(sys.argv[1:] if argv is None else argv))


def build_engine(cfg: dict, *, model=None, **engine_kw):
    """Engine + processor + kind/mcfg from a serve config.  ``model``: a
    model built already for ``model_family`` on the config's device (e.g.
    one shared by two engines) instead of one drawn from ``seed``; with
    ``quantize_base`` it is quantized in place (a quantized one passes
    through).  ``engine_kw`` passes extra ServingEngine arguments
    (``attn_impl``, ``on_prefill``)."""
    dtype = dtype_of(cfg)
    device = resolve_device(cfg.get("device"))
    model_cfg = get_model_identifiers(cfg["model_family"])
    processor = build_processor(model_cfg, cfg)
    if model is None:
        kind, mcfg, model = init_or_load_params(model_cfg, cfg.get("model_path"),
                                                seed=int(cfg.get("seed") or 0), dtype=dtype,
                                                device=device)
    else:
        kind, mcfg = model_kind(model_cfg), build_model_config(model_cfg)
        if model.cfg != mcfg:
            raise ValueError(f"the model given is not a {cfg['model_family']} model")
    if cfg.get("quantize_base"):
        model = quantize_base_params(model, kind, cfg["quantize_base"])
    cache_dtype = torch.int8 if str(cfg.get("kv_cache_dtype") or "") == "int8" else dtype
    tok = processor.tokenizer
    # multi-LoRA: {name: dir-with-adapter.safetensors} -> one engine serves
    # every sweep variant; requests pick theirs via an "adapter" field
    adapters = None
    if cfg.get("adapters"):
        adapters = {name: load_adapter(path, device=device)
                    for name, path in dict(cfg["adapters"]).items()}
    engine = ServingEngine(
        model, mcfg, kind,
        num_slots=int(cfg.get("num_slots", 8)),
        max_len=int(cfg.get("max_length", 2048)),
        chunk=int(cfg.get("chunk", 16)),
        pad_token_id=tok.pad_token_id,
        eos_token_id=tok.eos_token_id,
        cache_dtype=cache_dtype, compute_dtype=dtype,
        speculate_k=int(cfg.get("speculative_k") or 0),
        spec_ref_len=int(cfg.get("spec_ref_len") or 0),
        temperature=float(cfg.get("temperature") or 0.0),
        top_k=int(cfg.get("top_k") or 0),
        top_p=float(cfg.get("top_p") or 1.0),
        adapters=adapters,
        prefill_chunk=int(cfg.get("prefill_chunk") or 0),
        page_size=int(cfg.get("page_size") or 0),
        kv_pool_pages=int(cfg.get("kv_pool_pages") or 0) or None,
        logprobs=bool(cfg.get("logprobs", False)),
        device=device,
        **engine_kw,
    )
    return engine, processor, kind, mcfg


def load_image(img, processor) -> np.ndarray:
    """A request's image (a path, or an array-like) as the model takes it:
    CLIP-normalized [image_size, image_size, 3] f32 (LLaVA) or Qwen2-VL's
    patches [N, patch_dim] (``processor.preprocess``); PIL is imported only
    for a path."""
    if isinstance(img, str):
        from PIL import Image

        img = np.asarray(Image.open(img).convert("RGB"))
    return processor.preprocess(np.asarray(img)).astype(np.float32)


def run(cfg: dict):
    engine, processor, kind, mcfg = build_engine(cfg)
    tok = processor.tokenizer
    # shared system prompt -> prefix cache: prefilled once, every text-only
    # request prefills just its own (template-formatted) suffix
    prefix_id = None
    if cfg.get("system_prompt"):
        prefix_id = engine.register_prefix(
            tok.encode(str(cfg["system_prompt"]), add_special_tokens=True))
    default_new = int(cfg["generation"]["max_new_tokens"])
    reqs, texts, stop_strs = [], [], []
    with open(cfg["requests"]) as f:
        for line in f:
            if not line.strip():
                continue
            r = json.loads(line)
            has_image = r.get("image") is not None and kind in VLM_KINDS
            ids = processor._encode_expand(processor.format(r["question"], None, has_image))
            pix = load_image(r["image"], processor) if has_image else None
            # "stop": string or list of strings, matched on the text
            stops = r.get("stop") or []
            stop_strs.append([stops] if isinstance(stops, str) else list(stops))
            # optional "draft": expected-answer text seeding the speculative
            # lookup corpus; output stays exactly greedy either way
            dref = tok.encode(r["draft"]) if r.get("draft") else None
            reqs.append(engine.submit(ids, int(r.get("max_new_tokens", default_new)),
                                      pixel_values=pix, draft_ref=dref,
                                      sample_seed=r.get("sample_seed"),
                                      prefix=None if has_image else prefix_id,
                                      adapter=r.get("adapter")))
            texts.append(r["question"])

    t0 = time.perf_counter()
    cut_text: list[str | None] = [None] * len(reqs)
    while not all(r.done for r in reqs):
        engine.step()
        for i, req in enumerate(reqs):
            if req.done or not stop_strs[i] or cut_text[i] is not None:
                continue
            text = tok.decode(req.tokens, skip_special_tokens=True)
            cuts = [text.find(s) for s in stop_strs[i] if s in text]
            if cuts:
                cut_text[i] = text[: min(cuts)]
                engine.cancel(req)
    dt = time.perf_counter() - t0

    results = []
    with open(cfg["save_file"], "w") as f:
        for i, (question, req) in enumerate(zip(texts, reqs)):
            completion = (cut_text[i] if cut_text[i] is not None
                          else tok.decode(req.tokens, skip_special_tokens=True))
            # a stop can land inside the final chunk after a natural finish
            late = [completion.find(s) for s in stop_strs[i] if s in completion]
            if late:
                completion = completion[: min(late)]
            row = {"question": question, "completion": completion, "tokens": len(req.tokens)}
            if engine.want_lp:
                row["logprobs"] = [round(x, 6) for x in req.logprobs]
            results.append(row)
            f.write(json.dumps(row) + "\n")
    n_tok = sum(len(r.tokens) for r in reqs)
    st = engine.stats()
    pool = (f"; paged pool {st['pool_pages']} pages of {engine.page}, peak "
            f"{st['pool_pages_peak']}, {st['preemptions']} preemptions"
            if engine.page else "")
    tower = engine.params.language_model if kind in VLM_KINDS else engine.params
    print(f"served {len(reqs)} requests, {n_tok} tokens in {dt:.1f}s "
          f"({n_tok / max(dt, 1e-9):.1f} tok/s; {st['dispatches']} dispatches, "
          f"{st['tokens_per_round']:.2f} tok/round{pool}; decoder weights "
          f"{tree_nbytes(tower) / 2**30:.3f} GiB, quantize_base={cfg.get('quantize_base')}) "
          f"on {engine.device} -> {cfg['save_file']}")
    return results


def main(argv=None):
    return run(load_config(argv))


if __name__ == "__main__":
    main()
