"""The port's offline quantizer (``cli/quantize_model.py``) against the JAX
package's, on the CPU: both read the same dense HF-layout checkpoint of
``small-llava-test`` (a decoder 256 wide, so that the quantizer quantizes
it; written by the port's ``save_model`` in f32) and write int8 or grouped
int4 checkpoints.

- The two ``model.quant.safetensors`` hold the same names, the same integer
  arrays exactly and the same scales and float leaves (within 1e-6), and
  ``quantize_meta.json`` the same bits, family and dtype; the two CLIs
  print the same line and return the same byte counts.
- Each output loads in the other package's loader with every leaf equal,
  and the port's loads in ``cli/serve.py model_path=`` as a quantized
  model (``QTensor`` / ``QTensor4`` leaves) that serves a request.
"""

import json

import numpy as np
import pytest
import torch
from safetensors.numpy import load_file

from multimodal_unlearning_tpu.cli import common as jcommon
from multimodal_unlearning_tpu.cli import quantize_model as jquant
from multimodal_unlearning_tpu.config import get_model_identifiers
from multimodal_unlearning_tpu_torch.cli import common as tcommon
from multimodal_unlearning_tpu_torch.cli import quantize_model as tquant
from multimodal_unlearning_tpu_torch.cli import serve as tserve
from multimodal_unlearning_tpu_torch.config import get_model_identifiers as tget
from multimodal_unlearning_tpu_torch.utils.pytree import tree_leaves_with_path
from multimodal_unlearning_tpu_torch.utils.quantize import QTensor, QTensor4

FAMILY = "small-llava-test"


@pytest.fixture(scope="module")
def dense_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("dense")
    _, _, model = tcommon.init_or_load_params(tget(FAMILY), None, seed=3, dtype=torch.float32,
                                              device="cpu")
    tcommon.save_model(d, tget(FAMILY), model)
    return d


@pytest.mark.parametrize("bits", ["int8", "int4"])
def test_quantize_cli_equals_jax_and_loads_in_both(dense_dir, tmp_path, bits, capsys):
    args = [f"model_family={FAMILY}", f"model_path={dense_dir}", f"bits={bits}",
            "dtype=float32"]
    capsys.readouterr()
    want = jquant.main(args + [f"save_dir={tmp_path / 'jax'}"])
    jline = capsys.readouterr().out.strip().splitlines()[-1]
    got = tquant.main(args + [f"save_dir={tmp_path / 'port'}", "+device=cpu"])
    tline = capsys.readouterr().out.strip().splitlines()[-1]
    assert got == {k: int(v) for k, v in want.items()}
    assert tline.replace(str(tmp_path / "port"), "X") == jline.replace(str(tmp_path / "jax"), "X")
    jf = load_file(str(tmp_path / "jax" / "model.quant.safetensors"))
    tf = load_file(str(tmp_path / "port" / "model.quant.safetensors"))
    assert tf.keys() == jf.keys()
    assert any(k.endswith("/q4" if bits == "int4" else "/q") for k in tf)
    for k in jf:
        assert tf[k].dtype == jf[k].dtype and tf[k].shape == jf[k].shape, k
        if np.issubdtype(jf[k].dtype, np.integer):
            np.testing.assert_array_equal(tf[k], jf[k], err_msg=k)
        else:
            np.testing.assert_allclose(tf[k], jf[k], rtol=1e-6, atol=1e-7, err_msg=k)
    meta = [json.loads((tmp_path / d / "quantize_meta.json").read_text()) for d in ("jax", "port")]
    assert meta[0] == meta[1] and meta[1]["bits"] == bits

    # the port's output in the JAX loader, the JAX output in the port's
    import jax

    _, _, jtree = jcommon.init_or_load_params(get_model_identifiers(FAMILY),
                                              str(tmp_path / "port"), seed=0)
    _, _, tmodel = tcommon.init_or_load_params(tget(FAMILY), str(tmp_path / "jax"),
                                               dtype=torch.float32, device="cpu")
    jleaves = dict(tree_leaves_with_path(jax.tree.map(np.asarray, jtree)))
    tleaves = dict(tree_leaves_with_path(tcommon.model_tree(tmodel)))
    assert jleaves.keys() == tleaves.keys()
    for k, v in jleaves.items():
        np.testing.assert_allclose(tleaves[k].float().numpy(), v.astype(np.float32),
                                   rtol=1e-6, atol=1e-7, err_msg=str(k))
    # the port's checkpoint served through cli/serve.py model_path=
    engine, _, _, _ = tserve.build_engine(tserve.load_config([
        f"model_family={FAMILY}", f"model_path={tmp_path / 'port'}", "device=cpu",
        "dtype=float32", "num_slots=1", "max_length=256"]))
    q = engine.params.language_model.layers.q_proj
    assert isinstance(q, QTensor4 if bits == "int4" else QTensor)
    req = engine.submit([1, 5, 9, 30], 3)
    assert len(engine.drain([req])[0]) == 3
