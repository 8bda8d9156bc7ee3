"""Checkpoints: HF-layout safetensors, raw LoRA adapters, quantized trees and
the train state.

The port's copy of ``multimodal_unlearning_tpu/train/checkpoints.py``.  The
model files are the JAX package's formats, so either package reads what
the other writes:

- ``save_hf_checkpoint`` / ``load_hf_checkpoint``: ``model.safetensors``
  (HF names, every ``model*.safetensors`` shard read) plus ``config.json``;
- ``save_adapter`` / ``load_adapter``: ``adapter.safetensors`` ('/'-joined
  tree paths) plus ``adapter_meta.json`` with the alpha/r scale;
- ``save_quantized_checkpoint`` / ``load_quantized_checkpoint``:
  ``model.quant.safetensors`` with ``<leaf>/q`` or ``<leaf>/q4`` and
  ``<leaf>/s`` entries plus ``quantize_meta.json`` (legacy int4 files are
  converted by ``_legacy_int4_to_q4``).

The train state is the port's own format (the JAX package writes Orbax,
which is JAX-only): ``<dir>/step_<n>/train_state.safetensors`` holding
every tensor of the ``TrainState`` under its '/'-joined path (trainable
tree, dense or LoRA; optimizer count and moments, ``adamw_q8``'s int8 / uint8
blocks and f32 scales included; the RMU control vector; the initial model
of ``l_norm_from: init``; step), written under a temporary name
and renamed when complete, so a directory named ``step_<n>`` is always a
finished one.  Every file is in the ``safetensors`` format: written by
``_save``, read by the ``safetensors`` package.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import re
import shutil
import struct
import threading
from collections.abc import Mapping
from pathlib import Path

import numpy as np
import torch
from safetensors import safe_open
from safetensors.torch import load_file

from multimodal_unlearning_tpu_torch.utils.pytree import tree_leaves_with_path


# safetensors' names of the dtypes a checkpoint holds
_ST_DTYPES = {torch.float64: "F64", torch.float32: "F32", torch.float16: "F16",
              torch.bfloat16: "BF16", torch.int64: "I64", torch.int32: "I32",
              torch.int16: "I16", torch.int8: "I8", torch.uint8: "U8", torch.bool: "BOOL"}
# the pinned host buffer a tensor on the card passes through on its way to
# the file
_STAGE_BYTES = 256 << 20


def _permuted_on_card(t: torch.Tensor) -> torch.Tensor:
    """A host tensor that is a permuted view of contiguous memory (the HF
    layout's transposes of a merged tree) as the same view of a card copy
    of that memory; any other tensor as it is.  The host's strided copy ran
    at 0.49 GB/s on the H100's host, the card's route past 2.6 GB/s
    (``io_bench.py``)."""
    order = sorted(range(t.dim()), key=lambda i: -t.stride(i))
    base = t.permute(order)
    if not base.is_contiguous():
        return t
    return base.to("cuda").permute([order.index(i) for i in range(t.dim())])


def _save(tensors: dict, path, metadata: dict | None = None) -> None:
    """Write ``tensors`` as one safetensors file, tensor by tensor, without
    a copy of the whole file on the host: a tensor on the card goes through
    one pinned host buffer, a contiguous host tensor is written from its own
    memory, and a permuted host view is permuted on the card when there is
    one (else made contiguous on the host), one at a time.  The layout is
    the format's: the header's length (8 bytes, little-endian), the JSON
    header (each tensor's dtype, shape and data offsets, and
    ``__metadata__``) padded with spaces to 8 bytes, then the tensors'
    bytes back to back; ``safetensors`` reads it."""
    items = [(name, torch.as_tensor(t).detach()) for name, t in tensors.items()]
    header = {"__metadata__": dict(metadata)} if metadata else {}
    end = 0
    for name, t in items:
        n = t.numel() * t.element_size()
        header[name] = {"dtype": _ST_DTYPES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [end, end + n]}
        end += n
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    stage = None
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for _, t in items:
            if t.device.type == "cpu" and not t.is_contiguous() and torch.cuda.is_available():
                t = _permuted_on_card(t)
            flat = t.contiguous().reshape(-1).view(torch.uint8)
            if flat.device.type == "cpu":
                f.write(flat.numpy().data)
                continue
            if stage is None:
                stage = torch.empty(min(_STAGE_BYTES, end), dtype=torch.uint8, pin_memory=True)
            for i in range(0, flat.numel(), stage.numel()):
                part = stage[:min(stage.numel(), flat.numel() - i)]
                part.copy_(flat[i:i + part.numel()])
                f.write(part.numpy().data)


def model_checkpoint_exists(path) -> bool:
    """A directory holding ``pytorch*.bin`` or ``model*.safetensors``."""
    p = Path(path)
    if not p.exists():
        return False
    return any(re.search(r"pytorch.*\.bin", f.name) or re.search(r"model.*\.safetensors", f.name)
               for f in p.glob("*"))


def save_hf_checkpoint(save_dir, state_dict: dict, config: dict | None = None) -> None:
    """Write ``model.safetensors`` (tensor by tensor) and ``config.json``."""
    p = Path(save_dir)
    p.mkdir(parents=True, exist_ok=True)
    _save(state_dict, p / "model.safetensors", metadata={"format": "pt"})
    if config is not None:
        (p / "config.json").write_text(json.dumps(config, indent=2))


class HFCheckpoint(Mapping):
    """The tensors of every ``model*.safetensors`` shard of a directory, read
    from the file only when a name is looked up: ``sd[name]`` gives that one
    tensor, on the host.  Keeps the files open while it lives."""

    def __init__(self, path):
        p = Path(path)
        shards = sorted(p.glob("model*.safetensors")) or sorted(p.glob("*.safetensors"))
        if not shards:
            raise FileNotFoundError(f"No safetensors checkpoint under {p}")
        self._files = contextlib.ExitStack()
        self._where = {}
        for shard in shards:
            f = self._files.enter_context(safe_open(str(shard), framework="pt"))
            self._where.update(dict.fromkeys(f.keys(), f))

    def __getitem__(self, name: str) -> torch.Tensor:
        return self._where[name].get_tensor(name)

    def __iter__(self):
        return iter(self._where)

    def __len__(self) -> int:
        return len(self._where)

    def close(self) -> None:
        self._files.close()


def load_hf_checkpoint(path) -> HFCheckpoint:
    """All ``model*.safetensors`` shards of a directory as one state dict."""
    return HFCheckpoint(path)


def _flat(tree) -> dict:
    return {"/".join(map(str, path)): leaf for path, leaf in tree_leaves_with_path(tree)
            if leaf is not None}


def _nest(flat: dict) -> dict:
    tree: dict = {}
    for key, val in flat.items():
        node = tree
        parts = key.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = val
    return tree


def save_adapter(save_dir, adapters: dict, scale: float, meta: dict | None = None) -> None:
    """A raw LoRA adapter tree (``adapter.safetensors``, '/'-joined keys) and
    ``adapter_meta.json`` carrying the alpha/r scale."""
    p = Path(save_dir)
    p.mkdir(parents=True, exist_ok=True)
    _save(_flat(adapters), p / "adapter.safetensors")
    (p / "adapter_meta.json").write_text(json.dumps(dict(meta or {}, scale=float(scale)),
                                                    indent=2))


def load_adapter(path, device="cpu"):
    """(adapter tree, scale) of a ``save_adapter`` directory, the tree on
    ``device``."""
    p = Path(path)
    tree = _nest({k: v.to(device) for k, v in load_file(str(p / "adapter.safetensors")).items()})
    meta = json.loads((p / "adapter_meta.json").read_text())
    return tree, float(meta["scale"])


# ---------------------------------------------------------------------------
# Quantized checkpoints (the offline quantizer's output)
# ---------------------------------------------------------------------------

_QUANT_FILE = "model.quant.safetensors"
_QUANT_META = "quantize_meta.json"


def quantized_checkpoint_exists(path) -> bool:
    return (Path(path) / _QUANT_FILE).exists()


def _legacy_int4_to_q4(packed: np.ndarray, shape) -> np.ndarray:
    """Legacy format (flat uint8 nibbles of a jnp.int4 array) -> the runtime
    q4 layout (int8 nibble pairs along the contracting dim, half-split)."""
    lo = packed & 0xF
    hi = packed >> 4
    vals = np.empty(packed.size * 2, np.int8)
    vals[0::2] = lo
    vals[1::2] = hi
    vals = np.where(vals > 7, vals - 16, vals).astype(np.int8)  # sign-extend
    vals = vals.reshape(shape)
    half = shape[-2] // 2
    lo2, hi2 = vals[..., :half, :], vals[..., half:, :]
    return ((lo2 & 0xF) | (hi2 << 4)).astype(np.int8)


def save_quantized_checkpoint(save_dir, params: dict, meta: dict | None = None) -> None:
    """A dict tree with quantized ``{"q"|"q4", "s"}`` leaves, '/'-joined."""
    p = Path(save_dir)
    p.mkdir(parents=True, exist_ok=True)
    _save(_flat(params), p / _QUANT_FILE)
    (p / _QUANT_META).write_text(json.dumps(dict(meta or {}, int4_shapes={}), indent=2))


def load_quantized_checkpoint(path, dtype=None, device="cpu"):
    """(tree, meta): integer leaves stay integer (legacy int4 converted to
    q4), scales of quantized leaves stay f32, other float leaves cast to
    ``dtype`` when given; every tensor on ``device``."""
    p = Path(path)
    meta = json.loads((p / _QUANT_META).read_text())
    int4_shapes = meta.get("int4_shapes", {})
    flat = {}
    with safe_open(str(p / _QUANT_FILE), framework="pt") as f:
        # the leaves stored quantized: their scales stay f32
        quantized = {k.rsplit("/", 1)[0] for k in f.keys()
                     if k.endswith(("/q", "/q4")) or k in int4_shapes}
        for key in f.keys():
            val = f.get_tensor(key)
            if key in int4_shapes:
                val = torch.from_numpy(_legacy_int4_to_q4(val.numpy(), int4_shapes[key]))
                key = key.rsplit("/", 1)[0] + "/q4"
            leaf, _, name = key.rpartition("/")
            cast = (dtype is not None and val.is_floating_point()
                    and not (name == "s" and leaf in quantized))
            flat[key] = val.to(device=device, dtype=dtype if cast else val.dtype)
    return _nest(flat), meta


# ---------------------------------------------------------------------------
# Train state: the port's own format
# ---------------------------------------------------------------------------

_STATE_FILE = "train_state.safetensors"


def _state_flat(state) -> dict:
    return _flat({f.name: getattr(state, f.name) for f in dataclasses.fields(state)})


def _write_state(ckpt_dir: Path, step: int, flat: dict) -> None:
    final = ckpt_dir / f"step_{step}"
    tmp = ckpt_dir / f"step_{step}.tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    _save(flat, tmp / _STATE_FILE, metadata={"step": str(step)})
    shutil.rmtree(final, ignore_errors=True)
    tmp.rename(final)


def _host_snapshot(state) -> dict:
    return {k: v.detach().to("cpu", copy=True) for k, v in _state_flat(state).items()}


def save_train_state(ckpt_dir, step: int, state) -> None:
    _write_state(Path(ckpt_dir).resolve(), step, _host_snapshot(state))


class TrainStateCheckpointer:
    """Train-state checkpoints, written on a background thread.

    The device -> host snapshot is the only synchronous part; the write and
    the pruning to the newest ``keep_last`` step directories (0/None keeps
    every one; the latest is never pruned) overlap training.  An error of the
    write is raised again by the next ``save`` or ``wait``."""

    def __init__(self, ckpt_dir, *, async_save: bool = True, keep_last: int | None = None):
        self.dir = Path(ckpt_dir).resolve()
        self.async_save = async_save
        self.keep_last = int(keep_last or 0)
        self._thread = None
        self._error = None

    def _write(self, step: int, host_state: dict):
        try:
            _write_state(self.dir, step, host_state)
            if self.keep_last > 0:
                for old in sorted(_finalized_steps(self.dir))[: -self.keep_last]:
                    shutil.rmtree(self.dir / f"step_{old}", ignore_errors=True)
        except Exception as e:  # raised again by the next save() / wait()
            self._error = e

    def save(self, step: int, state) -> None:
        # drain the write in flight first: two host snapshots at once would
        # double the host memory the checkpoints take
        self.wait()
        host_state = _host_snapshot(state)
        if self.async_save:
            self._thread = threading.Thread(target=self._write, args=(step, host_state),
                                            daemon=True)
            self._thread.start()
        else:
            self._write(step, host_state)
            self._raise_pending()

    def wait(self) -> None:
        """Block until the write in flight (if any) lands; raise its error."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._raise_pending()

    def _raise_pending(self):
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError(f"async checkpoint write failed: {err}") from err


def _finalized_steps(p: Path) -> list[int]:
    """The ``step_<n>`` directories, not a write in progress (``.tmp``)."""
    out = []
    for d in p.glob("step_*"):
        tail = d.name.split("_", 1)[1]
        if d.is_dir() and tail.isdigit():
            out.append(int(tail))
    return out


def latest_train_state_step(ckpt_dir) -> int | None:
    p = Path(ckpt_dir)
    if not p.exists():
        return None
    steps = _finalized_steps(p)
    return max(steps) if steps else None


def restore_train_state(ckpt_dir, step: int, template):
    """The state saved at ``step``, copied into the tensors of ``template``
    (a ``TrainState`` built the same way), which is returned: a dense
    trainable tree is the model's own parameters, so the model takes the
    saved values too, bit for bit."""
    flat = load_file(str(Path(ckpt_dir) / f"step_{step}" / _STATE_FILE))
    want = _state_flat(template)
    if set(flat) != set(want):
        raise ValueError(f"train state at step {step} does not match the template: "
                         f"{sorted(set(flat) ^ set(want))}")

    def rebuild(prefix, node):
        if isinstance(node, dict):
            return {k: rebuild(f"{prefix}/{k}", v) for k, v in node.items()}
        if node is not None:
            with torch.no_grad():
                node.copy_(flat[prefix])
        return node

    for f in dataclasses.fields(template):
        rebuild(f.name, getattr(template, f.name))
    return template
