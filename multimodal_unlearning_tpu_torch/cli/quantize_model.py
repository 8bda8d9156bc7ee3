"""Offline model quantizer of the PyTorch port.

Counterpart of ``multimodal_unlearning_tpu/cli/quantize_model.py``:
quantization is a one-time offline step.  It loads a dense HF-layout
checkpoint (or draws the weights from ``seed`` without one), quantizes the
decoder tower (int8 per output channel, or grouped int4:
``cli/common.quantize_base_params``) and writes a native quantized
checkpoint (``model.quant.safetensors`` + ``quantize_meta.json``,
``train/checkpoints.save_quantized_checkpoint``).  Every entry point that
takes a ``model_path`` (``cli/serve.py``, ``cli/mm_eval.py``, the forget
CLI's base) detects that layout and loads the integer tree as it is, and
so does the JAX package's loader.

  python -m multimodal_unlearning_tpu_torch.cli.quantize_model \\
      model_family=llava model_path=ckpts/ft save_dir=ckpts/ft-int8 bits=int8

Overrides are ``key=value`` onto ``configs/quantize.yaml``; ``+device=cpu``
runs on the CPU (the card otherwise).
"""

from __future__ import annotations

from multimodal_unlearning_tpu_torch.cli import common
from multimodal_unlearning_tpu_torch.config import config_dir, get_model_identifiers
from multimodal_unlearning_tpu_torch.config import main as config_main
from multimodal_unlearning_tpu_torch.train import checkpoints
from multimodal_unlearning_tpu_torch.utils.quantize import tree_nbytes


def run(cfg):
    dtype = common.dtype_of(cfg)
    model_cfg = get_model_identifiers(cfg["model_family"])
    kind, _, model = common.init_or_load_params(
        model_cfg, cfg.get("model_path"), seed=cfg.get("seed", 42), dtype=dtype,
        device=cfg.get("device"))
    dense_bytes = tree_nbytes(model)
    bits = str(cfg.get("bits", "int8"))
    model = common.quantize_base_params(model, kind, bits)
    quant_bytes = tree_nbytes(model)
    checkpoints.save_quantized_checkpoint(
        cfg["save_dir"], common.model_tree(model),
        meta={"bits": bits, "model_family": cfg["model_family"],
              "dtype": str(cfg.get("dtype", "bfloat16"))})
    print(f"Quantized {cfg['model_family']} to {bits}: {dense_bytes / 2**30:.2f} GiB "
          f"-> {quant_bytes / 2**30:.2f} GiB "
          f"({dense_bytes / max(quant_bytes, 1):.2f}x) -> {cfg['save_dir']}")
    return {"dense_bytes": dense_bytes, "quant_bytes": quant_bytes}


main = config_main(config_dir(), "quantize")(run)

if __name__ == "__main__":
    main()
