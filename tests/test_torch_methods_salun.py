"""SalUn on the port (``methods/salun.py``, ``cli/salun_generate.py``)
against the JAX package's (CPU, f32, ``tiny-llama-test`` from one
checkpoint, synthetic data):

- the saliency |sum of forget-CE gradients| of both CLIs within 1e-5
  relative of each leaf's largest entry (two f32 computations of the same
  gradients over 2 batches);
- the port's mask files, written from the JAX package's saliency, equal
  its masks exactly (f16 ranking, stable descending order, ``int(t * n)``
  per tensor and per layer of a stacked leaf, ties at f16 overflow and at
  zero);
- each CLI's ``with_{t}.npz``: the same names, shapes and float32 arrays,
  exactly ``int(t * n)`` kept per row, nested, and equal to the other
  package's in all but the entries whose f16 ranks the 1e-5 differences of
  the two saliencies swap (at most 1e-3 of them).  The JAX CLI writes three
  of its ten thresholds here (``JAX_THRESHOLDS``): its eager mask builder
  compiles anew for each threshold's count, ~3 s each on one core; the
  port's CLI writes all ten;
- ``.npz`` files that load in the other package's ``load_mask`` and mask
  gradients alike (``apply_salun_mask``);
- the CLI's routes: the attention the registry's ``flash_attention2``
  names; a llava family, where the JAX CLI raises ``NameError`` (it names
  ``llava.forward`` without importing it), through the LLaVA forward on its
  text-only batches; any other kind a ``ValueError``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_unlearning_tpu.cli import salun_generate as jcli
from multimodal_unlearning_tpu.methods import salun as js
from multimodal_unlearning_tpu_torch.cli import common as tcommon
from multimodal_unlearning_tpu_torch.cli import salun_generate as tcli
from multimodal_unlearning_tpu_torch.config import build_model_config, get_model_identifiers
from multimodal_unlearning_tpu_torch.config import registry as tregistry
from multimodal_unlearning_tpu_torch.methods import salun as ts
from multimodal_unlearning_tpu_torch.models import llama as tllama
from multimodal_unlearning_tpu_torch.ops import attention as tattention

FAMILY = "tiny-llama-test"
DATA = "synthetic:n_persons=20"  # 8 forget rows: 2 batches of 4
SAL_RTOL = 1e-5
SWAPPED_MAX = 1e-3
JAX_THRESHOLDS = (0.1, 0.5, 1.0)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both CLIs from one checkpoint; each one's saliency caught on its way
    to the masks."""
    root = tmp_path_factory.mktemp("salun")
    mcfg = build_model_config(get_model_identifiers(FAMILY))
    model = tllama.init_params(mcfg, torch.Generator().manual_seed(3), device="cpu")
    tcommon.save_model(root / "ckpt", get_model_identifiers(FAMILY), model)
    args = [f"model_family={FAMILY}", f"model_path={root / 'ckpt'}", f"data_path={DATA}"]
    caught = {}
    mp = pytest.MonkeyPatch()
    orig_t, orig_j = ts.accumulate_saliency, js.accumulate_saliency

    def catch_port(*a, **kw):  # the CLI consumes its saliency: keep a copy
        sal = orig_t(*a, **kw)
        caught["port"] = jax.tree.map(lambda t: t.numpy().copy(), sal)
        return sal

    def catch_jax(*a, **kw):
        caught["jax"] = orig_j(*a, **kw)
        return caught["jax"]

    mp.setattr(ts, "accumulate_saliency", catch_port)
    mp.setattr(js, "accumulate_saliency", catch_jax)
    masks = js.masks_for_thresholds
    mp.setattr(js, "masks_for_thresholds", lambda sal: masks(sal, JAX_THRESHOLDS))
    try:
        tcli.main(args + [f"save_dir={root / 'port'}", "+device=cpu"])
        jcli.main(args + [f"save_dir={root / 'jax'}"])
    finally:
        mp.undo()
    return root, caught["port"], jax.tree.map(np.asarray, caught["jax"]), model


def _flat(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in kp): leaf
            for kp, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_saliency_matches_jax(runs):
    _, sal_t, sal_j, _ = runs
    ft, fj = _flat(sal_t), _flat(sal_j)
    assert ft.keys() == fj.keys()
    for k in fj:
        scale = np.abs(fj[k]).max()
        assert scale > 0, k
        np.testing.assert_allclose(ft[k], fj[k], rtol=0, atol=SAL_RTOL * scale, err_msg=k)


def _with_ties(sal):
    sal = jax.tree.map(np.copy, sal)
    sal["layers"]["q_proj"][0, :3] = 1e6      # f16 overflow: three ties at inf
    sal["norm"][:] = 0.0                      # all ties at zero
    return sal


def test_masks_from_jax_saliency_are_jax_masks(runs, tmp_path):
    """``save_saliency_masks`` on the JAX package's saliency (ties added):
    each file, read back by ``load_mask``, equals the JAX package's
    ``masks_for_thresholds`` exactly."""
    _, _, sal_j, _ = runs
    sal = _with_ties(sal_j)
    want = js.masks_for_thresholds(jax.tree.map(jnp.asarray, sal), JAX_THRESHOLDS)
    template = jax.tree.map(torch.from_numpy, sal)
    counts = ts.save_saliency_masks(jax.tree.map(torch.from_numpy, sal), str(tmp_path))
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted(
        f"with_{t}.npz" for t in ts.THRESHOLDS)
    for t in JAX_THRESHOLDS:
        fw = _flat(jax.tree.map(np.asarray, want[t]))
        fg = _flat(ts.load_mask(str(tmp_path / f"with_{t}.npz"), template))
        assert fw.keys() == fg.keys() == counts[t].keys()
        for k in fw:
            assert fg[k].dtype == torch.float32
            assert np.array_equal(fg[k].numpy(), fw[k]), (t, k)
            assert (_rows(k, fw[k]).sum(axis=1) == counts[t][k]).all(), (t, k)


def _rows(key, x):
    return x.reshape(x.shape[0], -1) if key.startswith("layers/") and x.ndim >= 2 \
        else x.reshape(1, -1)


def test_cli_mask_files(runs):
    """Each package's files: the same names, shapes and dtypes; exactly
    int(t * n) kept per row; nested; the t = 1.0 mask all ones; the two
    packages' masks differ only where f16 ranks swap."""
    root, _, _, _ = runs
    prev = None
    assert sorted(p.name for p in (root / "port").iterdir()) == sorted(
        f"with_{t}.npz" for t in ts.THRESHOLDS)
    for t in ts.THRESHOLDS:
        zt = np.load(root / "port" / f"with_{t}.npz")
        zj = np.load(root / "jax" / f"with_{t}.npz") if t in JAX_THRESHOLDS else None
        differ = total = 0
        for k in zt.files:
            a = zt[k]
            assert a.dtype == np.float32
            rows = _rows(k, a)
            assert (rows.sum(axis=1) == int(t * rows.shape[1])).all(), (t, k)
            if prev is not None:
                assert (prev[k] <= a).all(), (t, k)
            if zj is not None:
                assert zj[k].dtype == a.dtype and zj[k].shape == a.shape
                differ += int((a != zj[k]).sum())
                total += a.size
        if zj is not None:
            assert sorted(zt.files) == sorted(zj.files)
            assert differ <= SWAPPED_MAX * total, (t, differ, total)
        if t == 1.0:
            assert all((zt[k] == 1).all() for k in zt.files)
        prev = {k: zt[k] for k in zt.files}


def test_npz_files_cross(runs):
    """The port's file in the JAX package's ``load_mask`` and the JAX
    package's in the port's, masking the same gradients alike."""
    root, _, sal_j, model = runs
    jtree = jax.tree.map(lambda t: jnp.asarray(t.numpy()), tcommon.model_tree(model))
    ttree = tcommon.model_tree(model)
    for t in (0.5, 1.0):
        for writer in ("port", "jax"):
            path = root / writer / f"with_{t}.npz"
            jm, tm = js.load_mask(str(path), jtree), ts.load_mask(str(path), ttree)
            jg = js.apply_salun_mask(jtree, jm)
            tg = ts.apply_salun_mask(ttree, tm)
            fj, ft = _flat(jax.tree.map(np.asarray, jg)), _flat(tg)
            for k in fj:
                assert np.array_equal(ft[k].numpy(), fj[k]), (t, writer, k)


def test_cli_attention_follows_the_registry(tmp_path, monkeypatch):
    """``flash_attention2: "true"`` routes the CLI's forward and backward
    through ``FlashAttention`` (the kernels on the card); tiny-llama-test
    ships "false": the plain version."""
    calls = []
    apply = tattention.FlashAttention.apply
    monkeypatch.setattr(tattention.FlashAttention, "apply",
                        lambda *a: calls.append(1) or apply(*a))
    args = [f"model_family={FAMILY}", f"data_path={DATA}", "num_batches=1", "+device=cpu"]
    tcli.main(args + [f"save_dir={tmp_path / 'plain'}"])
    assert not calls
    entry = dict(dict.__getitem__(tregistry.PRESETS, FAMILY))
    entry["flash_attention2"] = "true"
    monkeypatch.setitem(tregistry.PRESETS, FAMILY, entry)
    tcli.main(args + [f"save_dir={tmp_path / 'flash'}"])
    assert len(calls) == build_model_config(get_model_identifiers(FAMILY)).num_layers


def test_llava_runs_and_other_kinds_raise(tmp_path, monkeypatch):
    """A llava family: the JAX CLI raises ``NameError``, the port's runs the
    LLaVA forward on the text-only batches (the tower's saliency is 0, its
    masks keep the first entries).  A qwen2_vl family raises."""
    args = ["model_family=tiny-llava-test", f"data_path={DATA}", "num_batches=1",
            "max_length=64"]
    # the JAX CLI's fault comes after its model is built: a stand-in model
    # skips the cost of building one
    mcfg = jcli.common.build_model_config(jcli.get_model_identifiers("tiny-llava-test"))
    monkeypatch.setattr(jcli.common, "init_or_load_params",
                        lambda *a, **k: ("llava", mcfg, {}))
    with pytest.raises(NameError, match="llava"):
        jcli.main(args + [f"save_dir={tmp_path / 'jax'}"])
    tcli.main(args + [f"save_dir={tmp_path / 'port'}", "+device=cpu"])
    z = np.load(tmp_path / "port" / "with_0.5.npz")
    assert any(k.startswith("language_model/") for k in z.files)
    assert any(k.startswith("vision_tower/") for k in z.files)
    with pytest.raises(ValueError, match="tiny-qwen2vl-test"):
        tcli.main(["model_family=tiny-qwen2vl-test", f"save_dir={tmp_path / 'q'}",
                   "+device=cpu"])
