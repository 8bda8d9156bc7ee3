"""HF-checkpoint bridge: the port's parameter trees <-> HF state dicts.

The port's copy of the llama, ViT and LLaVA maps of
``multimodal_unlearning_tpu/models/hf_bridge.py``:

- stacked decoder layers ``layers.<name>: [L, in, out]`` <-> per-layer HF
  keys ``model.layers.<i>.self_attn.<q,k,v,o>_proj.weight`` (HF Linear
  weights are [out, in]: transposed);
- the ViT tower <-> CLIP's ``vision_tower.vision_model.encoder.layers.<i>``;
- the projector <-> ``multi_modal_projector.linear_{1,2}``;
- Qwen2-VL / Qwen2.5-VL (the published flat layout: the decoder under
  ``model.`` with q/k/v biases, the tower under ``visual.`` with fused qkv
  and a conv3d patch embedding).

A tree here is a nested dict of tensors at the port's (and the JAX
package's) paths.  ``*_to_hf`` returns views where it can (transposes,
layer slices): the safetensors writer copies one tensor at a time.
``*_from_hf`` reads each HF tensor from ``sd`` (any mapping, e.g. an open
checkpoint that reads a tensor when it is looked up) and copies it once to
``device`` in ``dtype``: a stacked leaf is allocated there whole and each
layer's tensor is copied into its slice, so the tree is the only copy of
the weights on the device.
The neox, phi and stablelm maps come with those model families.
"""

from __future__ import annotations

import torch

_LLAMA_LAYER_MAP = {
    "q_proj": "self_attn.q_proj.weight",
    "k_proj": "self_attn.k_proj.weight",
    "v_proj": "self_attn.v_proj.weight",
    "o_proj": "self_attn.o_proj.weight",
    "gate_proj": "mlp.gate_proj.weight",
    "up_proj": "mlp.up_proj.weight",
    "down_proj": "mlp.down_proj.weight",
}
_LLAMA_NORM_MAP = {
    "input_layernorm": "input_layernorm.weight",
    "post_attention_layernorm": "post_attention_layernorm.weight",
}
_VIT_LAYER_MAP = {
    "q_proj": ("self_attn.q_proj.weight", True),
    "q_bias": ("self_attn.q_proj.bias", False),
    "k_proj": ("self_attn.k_proj.weight", True),
    "k_bias": ("self_attn.k_proj.bias", False),
    "v_proj": ("self_attn.v_proj.weight", True),
    "v_bias": ("self_attn.v_proj.bias", False),
    "o_proj": ("self_attn.out_proj.weight", True),
    "o_bias": ("self_attn.out_proj.bias", False),
    "fc1": ("mlp.fc1.weight", True),
    "fc1_bias": ("mlp.fc1.bias", False),
    "fc2": ("mlp.fc2.weight", True),
    "fc2_bias": ("mlp.fc2.bias", False),
}


def _t(x):
    return x.transpose(-1, -2)


def _getter(sd, device, dtype):
    return lambda k: sd[k].to(device=device, dtype=dtype, copy=True)


def _stacked(sd, keys, device, dtype, transpose=False):
    """The tensors of ``keys`` stacked on a new leading dimension, on
    ``device`` in ``dtype``: the result is allocated once and each tensor
    crosses to the device alone and is copied (transposed if asked) into its
    slice."""
    out = None
    for i, key in enumerate(keys):
        w = sd[key].to(device)
        w = _t(w) if transpose else w
        if out is None:
            out = torch.empty((len(keys), *w.shape), device=device, dtype=dtype)
        out[i].copy_(w)
    return out


def _transposed(sd, key, device, dtype):
    """One HF ``[out, in]`` weight as ``[in, out]`` on ``device`` in ``dtype``."""
    return _stacked(sd, [key], device, dtype, transpose=True)[0]


# ---------------------------------------------------------------------------
# Llama decoder
# ---------------------------------------------------------------------------


def llama_to_hf(params: dict, prefix: str = "") -> dict:
    lp = params["layers"]
    if "router" in lp:
        raise NotImplementedError("MoE decoders are not ported yet")
    sd = {f"{prefix}model.embed_tokens.weight": params["embed_tokens"],
          f"{prefix}model.norm.weight": params["norm"],
          f"{prefix}lm_head.weight": _t(params["lm_head"])}
    for i in range(lp["q_proj"].shape[0]):
        for ours, hf in _LLAMA_LAYER_MAP.items():
            sd[f"{prefix}model.layers.{i}.{hf}"] = _t(lp[ours][i])
        for ours, hf in _LLAMA_NORM_MAP.items():
            sd[f"{prefix}model.layers.{i}.{hf}"] = lp[ours][i]
        for b in ("q", "k", "v"):  # the Qwen2 family's q/k/v biases
            if f"{b}_bias" in lp:
                sd[f"{prefix}model.layers.{i}.self_attn.{b}_proj.bias"] = lp[f"{b}_bias"][i]
    return sd


def llama_from_hf(sd, num_layers: int, prefix: str = "", *, qkv_bias: bool = False,
                  device="cpu", dtype=torch.float32) -> dict:
    g = _getter(sd, device, dtype)

    def stacked(hf, transpose):
        return _stacked(sd, [f"{prefix}model.layers.{i}.{hf}" for i in range(num_layers)],
                        device, dtype, transpose)

    layers = {ours: stacked(hf, True) for ours, hf in _LLAMA_LAYER_MAP.items()}
    layers.update({ours: stacked(hf, False) for ours, hf in _LLAMA_NORM_MAP.items()})
    if qkv_bias:
        layers.update({f"{b}_bias": stacked(f"self_attn.{b}_proj.bias", False)
                       for b in ("q", "k", "v")})
    embed = g(f"{prefix}model.embed_tokens.weight")
    # a tied lm_head (Qwen2-VL-2B's) falls back to the embedding table
    head_key = f"{prefix}lm_head.weight"
    lm_head = (_transposed(sd, head_key, device, dtype) if head_key in sd
               else _t(embed).contiguous())
    return {"embed_tokens": embed, "layers": layers,
            "norm": g(f"{prefix}model.norm.weight"), "lm_head": lm_head}


# ---------------------------------------------------------------------------
# CLIP ViT tower
# ---------------------------------------------------------------------------


def vit_to_hf(params: dict, patch_size: int,
              prefix: str = "vision_tower.vision_model.") -> dict:
    pe = params["patch_embed"]  # [P*P*3, H] <- conv kernel [H, 3, P, P]
    P, H = patch_size, pe.shape[1]
    sd = {f"{prefix}embeddings.patch_embedding.weight": pe.reshape(P, P, 3, H).permute(3, 2, 0, 1),
          f"{prefix}embeddings.class_embedding": params["class_embed"],
          f"{prefix}embeddings.position_embedding.weight": params["pos_embed"],
          f"{prefix}pre_layrnorm.weight": params["pre_ln"]["scale"],
          f"{prefix}pre_layrnorm.bias": params["pre_ln"]["bias"],
          f"{prefix}post_layernorm.weight": params["post_ln"]["scale"],
          f"{prefix}post_layernorm.bias": params["post_ln"]["bias"]}
    lp = params["layers"]
    for i in range(lp["q_proj"].shape[0]):
        for ours, (hf, transpose) in _VIT_LAYER_MAP.items():
            w = lp[ours][i]
            sd[f"{prefix}encoder.layers.{i}.{hf}"] = _t(w) if transpose else w
        for ln_ours, ln_hf in (("ln1", "layer_norm1"), ("ln2", "layer_norm2")):
            sd[f"{prefix}encoder.layers.{i}.{ln_hf}.weight"] = lp[ln_ours]["scale"][i]
            sd[f"{prefix}encoder.layers.{i}.{ln_hf}.bias"] = lp[ln_ours]["bias"][i]
    return sd


def vit_from_hf(sd, num_layers: int, prefix: str = "vision_tower.vision_model.", *,
                device="cpu", dtype=torch.float32) -> dict:
    g = _getter(sd, device, dtype)
    conv = g(f"{prefix}embeddings.patch_embedding.weight")  # [H, 3, P, P]
    H, C, P, _ = conv.shape

    def stacked(hf, transpose=False):
        return _stacked(sd, [f"{prefix}encoder.layers.{i}.{hf}" for i in range(num_layers)],
                        device, dtype, transpose)

    layers = {ours: stacked(hf, transpose) for ours, (hf, transpose) in _VIT_LAYER_MAP.items()}
    for ln_ours, ln_hf in (("ln1", "layer_norm1"), ("ln2", "layer_norm2")):
        layers[ln_ours] = {"scale": stacked(f"{ln_hf}.weight"), "bias": stacked(f"{ln_hf}.bias")}
    return {
        "patch_embed": conv.permute(2, 3, 1, 0).reshape(P * P * C, H),
        "class_embed": g(f"{prefix}embeddings.class_embedding").reshape(-1),
        "pos_embed": g(f"{prefix}embeddings.position_embedding.weight"),
        "pre_ln": {"scale": g(f"{prefix}pre_layrnorm.weight"),
                   "bias": g(f"{prefix}pre_layrnorm.bias")},
        "post_ln": {"scale": g(f"{prefix}post_layernorm.weight"),
                    "bias": g(f"{prefix}post_layernorm.bias")},
        "layers": layers,
    }


# ---------------------------------------------------------------------------
# LLaVA assembly
# ---------------------------------------------------------------------------


def llava_to_hf(params: dict, patch_size: int) -> dict:
    sd = llama_to_hf(params["language_model"], prefix="language_model.")
    sd.update(vit_to_hf(params["vision_tower"], patch_size))
    pj = params["projector"]
    sd["multi_modal_projector.linear_1.weight"] = _t(pj["fc1"])
    sd["multi_modal_projector.linear_1.bias"] = pj["fc1_bias"]
    sd["multi_modal_projector.linear_2.weight"] = _t(pj["fc2"])
    sd["multi_modal_projector.linear_2.bias"] = pj["fc2_bias"]
    return sd


def llava_from_hf(sd, decoder_layers: int, vit_layers: int, *, device="cpu",
                  dtype=torch.float32) -> dict:
    g = _getter(sd, device, dtype)
    return {
        "language_model": llama_from_hf(sd, decoder_layers, prefix="language_model.",
                                        device=device, dtype=dtype),
        "vision_tower": vit_from_hf(sd, vit_layers, device=device, dtype=dtype),
        "projector": {
            "fc1": _transposed(sd, "multi_modal_projector.linear_1.weight", device, dtype),
            "fc1_bias": g("multi_modal_projector.linear_1.bias"),
            "fc2": _transposed(sd, "multi_modal_projector.linear_2.weight", device, dtype),
            "fc2_bias": g("multi_modal_projector.linear_2.bias"),
        },
    }


# ---------------------------------------------------------------------------
# Qwen2-VL / Qwen2.5-VL (text under "model.", the tower under "visual.")
# ---------------------------------------------------------------------------

_QWEN_QKV = ("q", "k", "v")


def _qwen_mlp_names(v25: bool):
    return ((("gate", "gate_proj"), ("up", "up_proj"), ("down", "down_proj")) if v25
            else (("fc1", "fc1"), ("fc2", "fc2")))


def qwen2vl_to_hf(params: dict) -> dict:
    """Either tower version (2.5 is told by its ``gate`` leaves).  The fused
    qkv weights and biases are concatenations, so they are new tensors; the
    rest are views."""
    sd = llama_to_hf(params["language_model"])
    vt = params["vision_tower"]
    bp = vt["blocks"]
    L, E = bp["q_proj"].shape[0], bp["q_proj"].shape[1]
    v25 = "gate" in bp
    pe = vt["patch_embed"]  # [patch_dim, E]: the patch vector in (c, t, ph, pw) order
    P = int(round((pe.shape[0] // 6) ** 0.5))
    sd["visual.patch_embed.proj.weight"] = _t(pe).reshape(E, 3, 2, P, P)
    for i in range(L):
        base = f"visual.blocks.{i}"
        sd[f"{base}.norm1.weight"] = bp["ln1"]["scale"][i]
        sd[f"{base}.norm2.weight"] = bp["ln2"]["scale"][i]
        if not v25:
            sd[f"{base}.norm1.bias"] = bp["ln1"]["bias"][i]
            sd[f"{base}.norm2.bias"] = bp["ln2"]["bias"][i]
        sd[f"{base}.attn.qkv.weight"] = torch.cat([_t(bp[f"{n}_proj"][i]) for n in _QWEN_QKV])
        sd[f"{base}.attn.qkv.bias"] = torch.cat([bp[f"{n}_bias"][i] for n in _QWEN_QKV])
        sd[f"{base}.attn.proj.weight"] = _t(bp["o_proj"][i])
        sd[f"{base}.attn.proj.bias"] = bp["o_bias"][i]
        for ours, hf in _qwen_mlp_names(v25):
            sd[f"{base}.mlp.{hf}.weight"] = _t(bp[ours][i])
            sd[f"{base}.mlp.{hf}.bias"] = bp[f"{ours}_bias"][i]
    m = vt["merger"]
    sd["visual.merger.ln_q.weight"] = m["ln_q"]["scale"]
    if not v25:
        sd["visual.merger.ln_q.bias"] = m["ln_q"]["bias"]
    sd["visual.merger.mlp.0.weight"] = _t(m["fc1"])
    sd["visual.merger.mlp.0.bias"] = m["fc1_bias"]
    sd["visual.merger.mlp.2.weight"] = _t(m["fc2"])
    sd["visual.merger.mlp.2.bias"] = m["fc2_bias"]
    return sd


def qwen2vl_from_hf(sd, decoder_layers: int, vision_depth: int, *, device="cpu",
                    dtype=torch.float32) -> dict:
    """Either tower version (2.5 is told by its ``gate_proj`` keys)."""
    g = _getter(sd, device, dtype)
    v25 = "visual.blocks.0.mlp.gate_proj.weight" in sd

    def stacked(hf, transpose=False):
        return _stacked(sd, [f"visual.blocks.{i}.{hf}" for i in range(vision_depth)], device,
                        dtype, transpose)

    def qkv_part(hf, j, E, transpose):
        out = None
        for i in range(vision_depth):
            w = sd[f"visual.blocks.{i}.{hf}"][j * E:(j + 1) * E].to(device)
            w = _t(w) if transpose else w
            if out is None:
                out = torch.empty((vision_depth, *w.shape), device=device, dtype=dtype)
            out[i].copy_(w)
        return out

    conv = g("visual.patch_embed.proj.weight")  # [E, 3, T, P, P]
    E = conv.shape[0]
    blocks = {f"ln{n}": {"scale": stacked(f"norm{n}.weight")} for n in (1, 2)}
    if not v25:
        for n in (1, 2):
            blocks[f"ln{n}"]["bias"] = stacked(f"norm{n}.bias")
    for j, n in enumerate(_QWEN_QKV):
        blocks[f"{n}_proj"] = qkv_part("attn.qkv.weight", j, E, True)
        blocks[f"{n}_bias"] = qkv_part("attn.qkv.bias", j, E, False)
    blocks["o_proj"] = stacked("attn.proj.weight", True)
    blocks["o_bias"] = stacked("attn.proj.bias")
    for ours, hf in _qwen_mlp_names(v25):
        blocks[ours] = stacked(f"mlp.{hf}.weight", True)
        blocks[f"{ours}_bias"] = stacked(f"mlp.{hf}.bias")
    ln_q = {"scale": g("visual.merger.ln_q.weight")}
    if not v25:
        ln_q["bias"] = g("visual.merger.ln_q.bias")
    return {
        "language_model": llama_from_hf(sd, decoder_layers, qkv_bias=True, device=device,
                                        dtype=dtype),
        "vision_tower": {
            "patch_embed": conv.reshape(E, -1).transpose(0, 1).contiguous(),
            "blocks": blocks,
            "merger": {
                "ln_q": ln_q,
                "fc1": _transposed(sd, "visual.merger.mlp.0.weight", device, dtype),
                "fc1_bias": g("visual.merger.mlp.0.bias"),
                "fc2": _transposed(sd, "visual.merger.mlp.2.weight", device, dtype),
                "fc2_bias": g("visual.merger.mlp.2.bias"),
            },
        },
    }
