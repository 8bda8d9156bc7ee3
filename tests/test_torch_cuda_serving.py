"""The sampler and the multi-LoRA bank on the card, in bf16.

- ``evaluation/sampling.py`` on CUDA tensors: keys, fold-ins, random bits
  and uniforms equal the CPU's bit for bit for the same seeds and indices
  (integer arithmetic and one exact float construction); the Gumbel noise
  agrees to a few f32 ulps (``log``); a sampling step (temperature, top-k,
  top-p) makes no host synchronisation (``torch.cuda.set_sync_debug_mode``).
- ``models/llama.dense`` with an adapter bank selected per row
  (``lora_ids``) and with the rows gathered already (``PER_ROW``), over an
  int8 weight (W8A16: dequantized) and a grouped-int4 weight (W4A16:
  kernel B8), against the plain route: each row's single-adapter product in
  f32 over the same dequantized weight.  Tolerance: the bf16 route rounds
  its activations, products and the delta to bf16, one ulp being 2^-8:
  max |err| <= 2e-2 of the largest plain output.

These tests need an NVIDIA GPU; elsewhere they skip.  On the card:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_serving.py -q
"""

import pytest
import torch

from multimodal_unlearning_tpu_torch.evaluation import sampling
from multimodal_unlearning_tpu_torch.models import llama
from multimodal_unlearning_tpu_torch.utils import quantize as tq

pytestmark = pytest.mark.cuda

REL_TOL = 2e-2


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("vocab", [7, 32000, 151936])
def test_sampler_bits_equal_the_cpu(dev, vocab):
    seeds = torch.tensor([0, 1, 42, 123456, 2 ** 31 - 1])
    idx = torch.tensor([0, 3, 159, 70000, 5])
    cpu = sampling.fold_in(sampling.row_keys(seeds), idx)
    card = sampling.fold_in(sampling.row_keys(seeds.to(dev)), idx.to(dev))
    assert torch.equal(card.cpu(), cpu)
    assert torch.equal(sampling.random_bits(card, vocab).cpu(), sampling.random_bits(cpu, vocab))
    assert torch.equal(sampling.uniform(card, vocab).cpu(), sampling.uniform(cpu, vocab))
    torch.testing.assert_close(sampling.gumbel(card, vocab).cpu(), sampling.gumbel(cpu, vocab),
                               rtol=1e-6, atol=1e-6)


def test_sampling_step_makes_no_host_sync(dev):
    gen = torch.Generator(device=dev).manual_seed(0)
    logits = torch.randn((8, 151936), generator=gen, device=dev, dtype=torch.bfloat16) * 3
    keys = sampling.row_keys(torch.arange(8, device=dev))
    idx = torch.arange(8, device=dev)
    torch.cuda.synchronize()
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        tok = sampling.sample_token(keys, idx, logits, 0.7, 50, 0.9)
        steps = torch.arange(4, device=dev)[:, None]
        step_keys = sampling.fold_in(keys[None], idx[None, :] + steps)
        more = sampling.sample_folded(step_keys[1], sampling.process_logits(logits, 0.7, 50, 0.9))
    finally:
        torch.cuda.set_sync_debug_mode(prev)
    assert tok.shape == more.shape == (8,)
    masked = sampling.process_logits(logits, 0.7, 50, 0.9)
    assert torch.isfinite(masked.gather(1, tok[:, None])).all()  # drawn inside the support


@pytest.mark.parametrize("bits", [8, 4])
def test_bank_over_quantized_weights_equals_plain(dev, bits):
    gen = torch.Generator(device=dev).manual_seed(1)
    B, S, d_in, d_out, r, A = 6, 3, 1536, 1024, 8, 3
    w = torch.randn((d_in, d_out), generator=gen, device=dev) * d_in ** -0.5
    leaf = tq.quantize_leaf(w) if bits == 8 else tq.quantize_leaf_int4(w)
    w_plain = tq.dequantize_leaf(leaf, torch.float32)
    x = torch.randn((B, S, d_in), generator=gen, device=dev).to(torch.bfloat16)
    a = torch.randn((A, d_in, r), generator=gen, device=dev) * d_in ** -0.5
    b = torch.randn((A, r, d_out), generator=gen, device=dev) * 0.05
    a[0] = 0
    b[0] = 0  # slot 0: the base model
    ids = torch.tensor([1, 0, 2, 2, 1, 0], device=dev)
    bank = {"a": a.to(torch.bfloat16), "b": b.to(torch.bfloat16)}
    got = llama.dense(x, leaf, bank, 1.0, ids)
    rows = {"a": bank["a"][ids], "b": bank["b"][ids]}
    same = llama.dense(x, leaf, rows, 1.0, llama.PER_ROW)
    assert torch.equal(same, got)
    x32 = x.float()
    want = x32 @ w_plain + torch.stack([(x32[i] @ a[ids[i]]) @ b[ids[i]] for i in range(B)])
    err = (got.float() - want).abs().max().item()
    assert err <= REL_TOL * want.abs().max().item(), err
