"""Online HTTP serving entry point of the PyTorch port.

Stands up a local OpenAI-completions-shaped endpoint over the
continuous-batching engine (serve/http.py), like
``multimodal_unlearning_tpu/cli/serve_http.py``: text requests POST
/v1/completions and are admitted into decode slots as they arrive, with the
engine's options (multi-LoRA ``adapters``, sampling, ``logprobs``,
speculation, the prefix cache, the paged KV cache, the int8 cache) applied
unchanged.  Standard library only.

  python -m multimodal_unlearning_tpu_torch.cli.serve_http \\
      model_family=llava page_size=128 'adapters={npo: out/npo/adapter}' \\
      host=127.0.0.1 port=8000

  curl -s localhost:8000/v1/completions -d \\
      '{"prompt": "Who is Aurelia Kim?", "max_tokens": 64, "adapter": "npo"}'

Overrides are those of ``cli/serve.py`` (the defaults of
``configs/mm/serve.yaml``), ``host`` and ``port`` included; the card is the
device unless ``device=cpu``.
"""

from __future__ import annotations

import time

from multimodal_unlearning_tpu_torch.cli.serve import build_engine, load_config
from multimodal_unlearning_tpu_torch.serve.http import EngineServer


def make_server(cfg: dict) -> EngineServer:
    """The EngineServer (engine + chat-template codec) of a serve config."""
    engine, processor, _, _ = build_engine(cfg)
    tok = processor.tokenizer

    def encode(text: str):
        return processor._encode_expand(processor.format(text, None, False))

    def decode(token_ids):
        return tok.decode(token_ids, skip_special_tokens=True)

    return EngineServer(engine, encode, decode,
                        default_max_tokens=int(cfg["generation"]["max_new_tokens"]))


def run(cfg: dict):
    server = make_server(cfg)
    host, port = server.serve(host=str(cfg.get("host") or "127.0.0.1"),
                              port=int(cfg.get("port") or 0))
    print(f"serving on http://{host}:{port}  (POST /v1/completions, GET /v1/stats, /health)",
          flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        server.shutdown()
    return server


def main(argv=None):
    return run(load_config(argv))


if __name__ == "__main__":
    main()
