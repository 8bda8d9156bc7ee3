"""Offline serving entry point of the PyTorch port.

Drains a JSONL request file through the continuous-batching engine
(serve/engine.py) and writes one completion per line, like
``multimodal_unlearning_tpu/cli/serve.py``.  Request lines:
{"question": str, "image": optional path or null, "max_new_tokens":
optional int, "stop": optional string or list of strings, "draft":
optional expected-answer text seeding the speculative lookup}.

  python -m multimodal_unlearning_tpu_torch.cli.serve \\
      model_family=llava requests=reqs.jsonl save_file=out.jsonl

As ``configs/mm/serve.yaml`` ships it, the decoder is int8 (W8A16,
``quantize_base=true``); ``quantize_base=int4`` (or ``int4:g64``, groups of
64 rows) serves a grouped-int4 decoder (W4A16, kernel B8, bf16 activations)
and ``quantize_base=false`` bf16 weights.  ``kv_cache_dtype=int8`` quantizes
the KV cache, ``speculative_k=4`` verifies prompt-lookup drafts,
``prefill_chunk=512`` prefills long prompts in chunks and
``system_prompt=...`` prefills a shared prefix once (text requests prefill
only their own suffix against it).
``page_size=128`` pages the KV cache (``kv_pool_pages=N`` caps the pool;
0 keeps the dense layout's capacity): the summary line then reports the
pool's peak pages and preemptions.

Overrides are ``key=value`` (dotted keys reach nested ones, e.g.
``generation.max_new_tokens=64``) onto the defaults of
``configs/mm/serve.yaml``, copied below for the keys this port reads.
Weights are random, drawn from ``seed`` (loading checkpoints is not
ported yet), and the tokenizer is the byte tokenizer.  ``device`` picks
the device: the card unless ``device=cpu``.
"""

from __future__ import annotations

import copy
import json
import sys
import time

import numpy as np
import torch

from multimodal_unlearning_tpu_torch.cli.common import quantize_base_params
from multimodal_unlearning_tpu_torch.config import (
    build_model_config, get_model_identifiers, model_kind)
from multimodal_unlearning_tpu_torch.data import ByteTokenizer, MMProcessor, preprocess_image
from multimodal_unlearning_tpu_torch.device import resolve_device
from multimodal_unlearning_tpu_torch.models import VLM_KINDS, decoder_module, vlm_module
from multimodal_unlearning_tpu_torch.serve import ServingEngine
from multimodal_unlearning_tpu_torch.utils.quantize import tree_nbytes

# configs/mm/serve.yaml, the keys this port reads (plus ``device``)
DEFAULTS = {
    "model_family": "llava",
    "model_path": None,
    "processor_path": None,
    "requests": "requests.jsonl",
    "save_file": "completions.jsonl",
    "num_slots": 8,
    "max_length": 2048,
    "chunk": 16,
    "speculative_k": 0,
    "spec_ref_len": 128,
    "temperature": 0.0,
    "top_k": 0,
    "top_p": 1.0,
    "prefill_chunk": 0,
    "page_size": 0,
    "kv_pool_pages": 0,
    "logprobs": False,
    "system_prompt": None,
    "adapters": None,
    "generation": {"max_new_tokens": 300},
    "dtype": "bfloat16",
    "quantize_base": True,
    "kv_cache_dtype": None,
    "seed": 42,
    "host": "127.0.0.1",  # cli/serve_http.py bind address
    "port": 8000,         # cli/serve_http.py port (0 = any free one)
    "device": None,
}

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _parse_value(text: str):
    low = text.strip().lower()
    if low in ("null", "none", "~", ""):
        return None
    if low in ("true", "false"):
        return low == "true"
    for cast in (int, float):
        try:
            return cast(text)
        except ValueError:
            pass
    return text.strip().strip("'\"")


def load_config(argv=None) -> dict:
    """DEFAULTS with ``key=value`` overrides applied; unknown keys raise."""
    cfg = copy.deepcopy(DEFAULTS)
    for arg in (sys.argv[1:] if argv is None else argv):
        key, sep, val = arg.partition("=")
        if not sep:
            raise ValueError(f"override {arg!r} is not key=value")
        *parents, leaf = key.split(".")
        node = cfg
        for p in parents:
            if not isinstance(node.get(p), dict):
                raise KeyError(f"unknown config key {key!r}")
            node = node[p]
        if leaf not in node:
            raise KeyError(f"unknown config key {key!r}; known: {sorted(node)}")
        node[leaf] = _parse_value(val)
    return cfg


def build_processor(model_cfg) -> MMProcessor:
    arch = model_cfg["arch"]
    if model_kind(model_cfg) in VLM_KINDS:
        vision = arch["vision"]
        tok = ByteTokenizer(vocab_size=int(arch["decoder"]["vocab_size"]),
                            image_token=arch.get("image_token", "<image>"),
                            image_token_id=int(arch["image_token_id"]))
        return MMProcessor(tok, image_size=int(vision["image_size"]),
                           num_image_tokens=(int(vision["image_size"])
                                             // int(vision["patch_size"])) ** 2,
                           chat_template=model_cfg.get("chat_template", "llava"))
    tok = ByteTokenizer(vocab_size=int(arch["vocab_size"]),
                        image_token_id=int(arch["vocab_size"]) - 1)
    tags = {k: model_cfg.get(k, "") for k in
            ("question_start_tag", "question_end_tag", "answer_tag")}
    return MMProcessor(tok, chat_template="__tags__", tags=tags, image_size=32,
                       num_image_tokens=0)


def build_engine(cfg: dict, *, model=None, **engine_kw):
    """Engine + processor + kind/mcfg from a serve config.  ``model``: a
    model built already for ``model_family`` on the config's device (e.g.
    one shared by two engines) instead of one drawn from ``seed``; with
    ``quantize_base`` it is quantized in place (a quantized one passes
    through).  ``engine_kw`` passes extra ServingEngine arguments
    (``attn_impl``, ``on_prefill``)."""
    unported = {
        "model_path": bool(cfg.get("model_path")),
        "processor_path": bool(cfg.get("processor_path")),
    }
    asked = [k for k, v in unported.items() if v]
    if asked:
        raise NotImplementedError(
            f"serve options not ported yet: {asked} (random weights from the seed, byte "
            "tokenizer)")
    dtype = DTYPES[str(cfg.get("dtype", "bfloat16"))]
    device = resolve_device(cfg.get("device"))
    model_cfg = get_model_identifiers(cfg["model_family"])
    kind = model_kind(model_cfg)
    mcfg = build_model_config(model_cfg)
    if model is None:
        init = (vlm_module(kind).init_params if kind in VLM_KINDS
                else decoder_module(mcfg).init_params)
        seed = int(cfg.get("seed") or 0)
        model = init(mcfg, torch.Generator(device=device).manual_seed(seed), device=device,
                     dtype=dtype)
    elif model.cfg != mcfg:
        raise ValueError(f"the model given is not a {cfg['model_family']} model")
    if cfg.get("quantize_base"):
        model = quantize_base_params(model, kind, cfg["quantize_base"])
    cache_dtype = torch.int8 if str(cfg.get("kv_cache_dtype") or "") == "int8" else dtype
    processor = build_processor(model_cfg)
    tok = processor.tokenizer
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
        adapters=cfg.get("adapters"),
        prefill_chunk=int(cfg.get("prefill_chunk") or 0),
        page_size=int(cfg.get("page_size") or 0),
        kv_pool_pages=int(cfg.get("kv_pool_pages") or 0) or None,
        logprobs=bool(cfg.get("logprobs", False)),
        device=device,
        **engine_kw,
    )
    return engine, processor, kind, mcfg


def load_image(img, image_size: int) -> np.ndarray:
    """A request's image (a path, or an array-like) -> CLIP-normalized
    [image_size, image_size, 3] f32; PIL is imported only for a path."""
    if isinstance(img, str):
        from PIL import Image

        img = np.asarray(Image.open(img).convert("RGB"))
    return preprocess_image(np.asarray(img), image_size).astype(np.float32)


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
            pix = load_image(r["image"], mcfg.vision.image_size) if has_image else None
            # "stop": string or list of strings, matched on the text
            stops = r.get("stop") or []
            stop_strs.append([stops] if isinstance(stops, str) else list(stops))
            # optional "draft": expected-answer text seeding the speculative
            # lookup corpus; output stays exactly greedy either way
            dref = tok.encode(r["draft"]) if r.get("draft") else None
            reqs.append(engine.submit(ids, int(r.get("max_new_tokens", default_new)),
                                      pixel_values=pix, draft_ref=dref,
                                      prefix=None if has_image else prefix_id))
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
