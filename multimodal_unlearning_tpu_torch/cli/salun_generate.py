"""SalUn mask generation, the port's entry point (reference:
methods/salun/generate_mask.py):

    python -m multimodal_unlearning_tpu_torch.cli.salun_generate \\
        model_family=llama2-7b model_path=<dir> save_dir=<dir>

Counterpart of ``multimodal_unlearning_tpu/cli/salun_generate.py``: reads
``configs/methods/salun.yaml`` with ``key=value`` overrides, accumulates
|sum of gradients| of the forget-set CE over every parameter for
``num_batches`` batches and writes the binary top-fraction masks
``with_{0.1..1.0}.npz`` into ``save_dir`` (``methods/salun.py``: one
threshold and one tensor at a time).

Attention follows the registry's ``flash_attention2`` (``common.train_flags``),
as in the port's other CLIs: the kernels B1-B3 on the card, the plain version
for families that turn it off.  A llava family runs the LLaVA forward on its
text-only batches; any other kind than llama and llava raises.  The card is
the device unless ``+device=cpu`` is given.
"""

from __future__ import annotations

import torch

from multimodal_unlearning_tpu_torch.cli import common
from multimodal_unlearning_tpu_torch.cli.nlp_finetune import text_tags
from multimodal_unlearning_tpu_torch.config import main as config_main
from multimodal_unlearning_tpu_torch.config.registry import config_dir, get_model_identifiers
from multimodal_unlearning_tpu_torch.data import DataLoader
from multimodal_unlearning_tpu_torch.data.nlp import TextForgetDatasetQA, text_collator
from multimodal_unlearning_tpu_torch.device import resolve_device
from multimodal_unlearning_tpu_torch.methods import salun
from multimodal_unlearning_tpu_torch.train.losses import ce_loss
from multimodal_unlearning_tpu_torch.train.loop import to_device
from multimodal_unlearning_tpu_torch.utils.pytree import param_tree, tree_leaves_with_path

KINDS = ("llama", "llava")


def make_grad_fn(model, dtype, attn_impl):
    """grad_fn(params, batch) -> the forget CE's gradient tree over every
    parameter (zeros where the loss does not reach, as ``jax.grad`` gives)."""
    def grad_fn(params, batch):
        paths, leaves = zip(*tree_leaves_with_path(params))
        out = model(batch["input_ids"], attention_mask=batch["attention_mask"],
                    compute_dtype=dtype, attn_impl=attn_impl)
        loss = ce_loss(out["logits"], batch["labels"])
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        tree = {}
        for path, leaf, g in zip(paths, leaves, grads):
            node = tree
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = torch.zeros_like(leaf) if g is None else g
        return tree

    return grad_fn


def run(cfg):
    device = resolve_device(cfg.get("device"))
    model_cfg = get_model_identifiers(cfg.model_family)
    dtype = common.dtype_of(cfg)
    kind = common.model_kind(model_cfg)
    if kind not in KINDS:
        raise ValueError(f"salun_generate: model family {cfg.model_family!r} is a {kind!r} "
                         f"model; SalUn runs the {' and '.join(KINDS)} families")
    kind, mcfg, model = common.init_or_load_params(model_cfg, cfg.get("model_path"),
                                                   seed=cfg.seed, dtype=dtype, device=device)
    processor = common.build_processor(model_cfg, cfg)
    ds = TextForgetDatasetQA(cfg.data_path, processor.tokenizer, text_tags(model_cfg),
                             max_length=cfg.max_length, split=cfg.split,
                             loss_type="grad_ascent", seed=cfg.seed)
    loader = DataLoader(ds, cfg.batch_size, text_collator, shuffle=True, seed=cfg.seed)
    params = param_tree(model)
    for _, p in tree_leaves_with_path(params):
        p.requires_grad_(True)
    grad_fn = make_grad_fn(model, dtype, common.train_flags(cfg, model_cfg)["attn_impl"])

    def batches():
        for i, batch in enumerate(loader):
            if i >= cfg.num_batches:
                return
            yield to_device(batch["forget"], device)

    sal = salun.accumulate_saliency(grad_fn, params, batches())
    salun.save_saliency_masks(sal, cfg.save_dir)
    print(f"Saved {len(salun.THRESHOLDS)} SalUn masks to {cfg.save_dir}")
    return list(salun.THRESHOLDS)


main = config_main(config_dir() / "methods", "salun")(run)

if __name__ == "__main__":
    main()
