"""Configuration files with ``key=value`` overrides: the port's copy of
``multimodal_unlearning_tpu/config/loader.py``.

- ``load_config(config_dir, config_name, overrides)`` reads
  ``<config_dir>/<config_name>.yaml`` (PyYAML's ``safe_load``, YAML 1.1
  scalars: ``1e-5`` is a string there) and applies the overrides;
- ``${a.b}`` interpolation, resolved lazily against the root; a whole-string
  ``${a.b}`` keeps the value's type (a whole node included);
- dotted overrides (``LoRA.r=8``), ``+key=val`` to add a key; the value is
  read as a YAML scalar, except that ``1e-5`` (an exponent without a dot,
  a string to PyYAML) is a float here, as in the JAX package;
- ``save_config`` writes the resolved config as YAML (``safe_dump``);
- ``main(config_path, config_name)`` wraps an entry point: it reads
  ``sys.argv`` (``--config-name`` picks another file) and calls ``fn(cfg)``.
"""

from __future__ import annotations

import functools
import re
import sys
from pathlib import Path
from typing import Any

import yaml

_INTERP_RE = re.compile(r"\$\{([^}]+)\}")


class Config(dict):
    """A dict with attribute access and lazy ``${...}`` interpolation.

    Nested dicts are wrapped on access so ``cfg.LoRA.r`` works.  String
    values containing ``${path.to.key}`` are resolved against the *root*
    config at read time, like OmegaConf interpolation.
    """

    def __init__(self, data: dict | None = None, root: "Config | None" = None):
        super().__init__(data or {})
        # root is carried so nested sections can resolve absolute interpolations
        object.__setattr__(self, "_root", root)

    # -- resolution -------------------------------------------------------
    def _get_root(self) -> "Config":
        root = object.__getattribute__(self, "_root")
        return root if root is not None else self

    def _resolve(self, value: Any) -> Any:
        if isinstance(value, dict) and not isinstance(value, Config):
            return Config(value, root=self._get_root())
        if isinstance(value, Config):
            return value
        if isinstance(value, list):
            return [self._resolve(v) for v in value]
        if isinstance(value, str) and "${" in value:
            return self._interpolate(value)
        return value

    def _interpolate(self, s: str) -> Any:
        root = self._get_root()

        def lookup(path: str) -> Any:
            node: Any = root
            for part in path.split("."):
                if isinstance(node, dict):
                    if part not in node:
                        raise KeyError(f"Interpolation key not found: ${{{path}}}")
                    node = dict.__getitem__(node, part)
                else:
                    raise KeyError(f"Interpolation key not found: ${{{path}}}")
            return node

        # whole-string interpolation preserves the value's type
        m = _INTERP_RE.fullmatch(s)
        if m:
            return self._resolve(lookup(m.group(1)))
        return _INTERP_RE.sub(lambda m: str(self._resolve(lookup(m.group(1)))), s)

    # -- mapping protocol -------------------------------------------------
    def __getitem__(self, key):
        value = dict.__getitem__(self, key)
        if isinstance(value, dict) and not isinstance(value, Config):
            # wrap ONCE and store the wrapper back so nested writes stick
            # (cfg["LoRA"]["r"] = 4 must mutate cfg, not a transient copy)
            value = Config(value, root=self._get_root())
            dict.__setitem__(self, key, value)
            return value
        return self._resolve(value)

    def get(self, key, default=None):
        try:
            return self[key]
        except KeyError:
            return default

    def __getattr__(self, key):
        try:
            return self[key]
        except KeyError as e:
            raise AttributeError(key) from e

    def __setattr__(self, key, value):
        self[key] = value

    def items(self):
        return [(k, self[k]) for k in dict.keys(self)]

    def values(self):
        return [self[k] for k in dict.keys(self)]

    def to_dict(self) -> dict:
        """Fully-resolved plain-dict copy."""
        out = {}
        for k in dict.keys(self):
            v = self[k]
            if isinstance(v, Config):
                v = v.to_dict()
            elif isinstance(v, list):
                v = [x.to_dict() if isinstance(x, Config) else x for x in v]
            out[k] = v
        return out


def _parse_value(raw: str) -> Any:
    """An override's value, read as a YAML scalar (``1e-5`` -> float)."""
    if raw == "":
        return ""
    try:
        val = yaml.safe_load(raw)
    except yaml.YAMLError:
        return raw
    if isinstance(val, str) and re.fullmatch(r"[+-]?\d+(\.\d*)?[eE][+-]?\d+", raw):
        return float(raw)
    return val


def _set_dotted(cfg: dict, dotted: str, value: Any, allow_new: bool) -> None:
    parts = dotted.split(".")
    node = cfg
    for p in parts[:-1]:
        if p not in node or not isinstance(dict.__getitem__(node, p), dict):
            if not allow_new:
                raise KeyError(f"Override path not in config: {dotted} (use +{dotted}=... to add)")
            dict.__setitem__(node, p, {})
        node = dict.__getitem__(node, p)
    if parts[-1] not in node and not allow_new:
        raise KeyError(f"Override key not in config: {dotted} (use +{dotted}=... to add)")
    dict.__setitem__(node, parts[-1], value)


def apply_overrides(cfg: Config, overrides: list[str]) -> Config:
    for ov in overrides:
        if "=" not in ov:
            raise ValueError(f"Override must be key=value, got: {ov}")
        key, _, raw = ov.partition("=")
        allow_new = key.startswith("+")
        key = key.lstrip("+")
        _set_dotted(cfg, key, _parse_value(raw), allow_new)
    return cfg


def load_config(config_dir: str | Path, config_name: str,
                overrides: list[str] | None = None) -> Config:
    path = Path(config_dir) / f"{config_name}.yaml"
    with open(path) as f:
        cfg = Config(yaml.safe_load(f) or {})
    if overrides:
        apply_overrides(cfg, overrides)
    return cfg


def save_config(cfg: Config, path: str | Path) -> None:
    """Snapshot the resolved config into the run directory."""
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        yaml.safe_dump(cfg.to_dict(), f, sort_keys=False)


def main(config_path: str | Path, config_name: str):
    """Decorator: parse ``sys.argv`` (or ``argv``) overrides and call fn(cfg)."""

    def decorator(fn):
        @functools.wraps(fn)
        def wrapper(argv: list[str] | None = None):
            args = list(sys.argv[1:] if argv is None else argv)
            name = config_name
            if "--config-name" in args:
                i = args.index("--config-name")
                name = args[i + 1]
                del args[i : i + 2]
            return fn(load_config(config_path, name, overrides=args))

        return wrapper

    return decorator
