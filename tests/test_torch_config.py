"""The port's configuration files (CPU): every ``configs/**/*.yaml`` read by
the port's ``load_config`` resolves to the same dict as through the JAX
package's, with PyYAML 1.1's scalar rules; overrides parse as the JAX
package's do; ``save_config`` writes YAML that PyYAML reads back to the same
dict; ``main`` honours ``--config-name``; the serve CLI's config is
``configs/mm/serve.yaml`` read the same way.  Exact equality throughout: no
tolerance."""

from pathlib import Path

import pytest
import yaml

from multimodal_unlearning_tpu.config import load_config as jload
from multimodal_unlearning_tpu.config.registry import get_model_identifiers as jget
from multimodal_unlearning_tpu_torch.config import Config, load_config, main, save_config
from multimodal_unlearning_tpu_torch.config.registry import config_dir, get_model_identifiers

CONFIGS = sorted(config_dir().rglob("*.yaml"))


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: str(p.relative_to(config_dir())))
def test_every_config_loads_as_in_jax(path):
    want = jload(path.parent, path.stem).to_dict()
    got = load_config(path.parent, path.stem).to_dict()
    assert got == want


def test_whole_node_interpolation_and_yaml11_scalars(tmp_path):
    # arch: ${llama2-7b.arch} interpolates a whole node
    assert get_model_identifiers("llama2-7b-eco").arch.to_dict() == \
        jget("llama2-7b-eco").arch.to_dict()
    cfg = load_config(config_dir() / "mm", "forget")
    assert cfg.lr == "1e-5"  # an exponent without a dot is a string to PyYAML 1.1
    assert cfg.LoRA.dropout == 0.0 and isinstance(cfg.LoRA.dropout, float)
    (tmp_path / "s.yaml").write_text(
        'a: 1.0e-5\nb: "false"\nc: yes\nd: ~\ne: 0x1f\nf: [1, x, {g: 017}]\nh: 1.0e5\n')
    got = load_config(tmp_path, "s").to_dict()
    assert got == jload(tmp_path, "s").to_dict()
    assert got["a"] == 1e-5 and got["b"] == "false" and got["c"] is True and got["d"] is None
    assert got["h"] == "1.0e5"  # no sign in the exponent: a string to PyYAML 1.1


@pytest.mark.parametrize("override", [
    "lr=1e-5", "LoRA.r=8", "+new=1", "x=null", "save_dir=a/${forget_loss}", "missing=1",
    "+mesh.pipe=2", "forget_split='forget05'", "mesh={data: 2, fsdp: 1}",
])
def test_overrides_parse_as_in_jax(override):
    base = config_dir() / "mm"
    key = override.lstrip("+").partition("=")[0]
    if key == "x":  # a key that the file does not have: both add it only with +
        override = "+" + override
    if key == "missing":
        with pytest.raises(KeyError):
            jload(base, "forget", [override])
        with pytest.raises(KeyError):
            load_config(base, "forget", [override])
        return
    want = jload(base, "forget", [override]).to_dict()
    got = load_config(base, "forget", [override]).to_dict()
    assert got == want
    if override == "lr=1e-5":
        assert got["lr"] == 1e-5  # in an override, 1e-5 is a float
    if override.startswith("save_dir"):
        assert got["save_dir"] == "a/grad_diff_forget_ce_retain_ce"


@pytest.mark.parametrize("name", ["forget", "eval", "serve"])
def test_save_config_reads_back_in_pyyaml(tmp_path, name):
    cfg = load_config(config_dir() / "mm", name, ["+extra.nested=[1, 2.5e-3, null, 'x: y']"])
    save_config(cfg, tmp_path / "config.yaml")
    text = (tmp_path / "config.yaml").read_text()
    assert yaml.safe_load(text) == cfg.to_dict()


def test_main_honours_config_name(tmp_path):
    (tmp_path / "a.yaml").write_text("x: 1\ny: ${x}\n")
    (tmp_path / "b.yaml").write_text("x: 2\ny: ['${x}', 3]\n")
    seen = []
    entry = main(tmp_path, "a")(lambda cfg: seen.append(cfg.to_dict()) or cfg)
    assert isinstance(entry([]), Config)
    entry(["--config-name", "b", "x=5"])
    assert seen == [{"x": 1, "y": 1}, {"x": 5, "y": [5, 3]}]


def test_config_dir_is_the_repos():
    assert config_dir() == Path(__file__).resolve().parents[1] / "configs"


@pytest.mark.parametrize("override", [
    "num_slots=3", "system_prompt=You are terse.", "quantize_base=int4", "model_path=/m",
])
def test_serve_config_is_the_serve_yaml(override):
    """``cli/serve.load_config`` is ``configs/mm/serve.yaml`` with the
    overrides as the JAX package reads them (``processor_path`` follows
    ``model_path``), plus the port's ``device`` key: null unless given,
    with or without ``+``."""
    from multimodal_unlearning_tpu_torch.cli import serve

    want = jload(config_dir() / "mm", "serve", [override]).to_dict()
    got = serve.load_config([override]).to_dict()
    assert got.pop("device") is None and got == want
    for dev in ("device=cpu", "+device=cpu"):
        assert serve.load_config([override, dev])["device"] == "cpu"
    with pytest.raises(KeyError):
        serve.load_config([override, "no_such_key=1"])
