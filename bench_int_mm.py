"""Time the W8A8 product ``utils.quantize.int_matmul`` on the card at the
forget step's shapes, by the memory layout of its second operand.

    python3 bench_int_mm.py

``torch._int_mm(a, b)`` multiplies int8 [M, K] by int8 [K, N].  The weights
are stored [in, out] row-major (the JAX tree's layout), so the forward
product sees a row-major ``b`` and the dx backward (``dy8 @ q.T``) a
column-major one.  For each shape this prints the time with ``b`` row-major,
with ``b`` column-major, of the layout copy alone, of ``int_matmul`` as the
port calls it, and of a bf16 matmul of the same shape as a yardstick.
Needs a CUDA device.
"""

from __future__ import annotations

import sys

import torch

from multimodal_unlearning_tpu_torch.bench import card_name
from multimodal_unlearning_tpu_torch.device import resolve_device
from multimodal_unlearning_tpu_torch.utils.quantize import int_matmul

# M = batch 2 x sequence 768; (K, N) of LLaVA-1.5-7B's projections and LM head
SHAPES = [(1536, 4096, 4096), (1536, 4096, 11008), (1536, 11008, 4096), (1536, 4096, 32064)]


def _ms(fn, iters=20, warmup=3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    dev = resolve_device(None)
    gen = torch.Generator(device=dev).manual_seed(0)
    print(f"card: {card_name(dev)}")
    for M, K, N in SHAPES:
        a = torch.randint(-127, 128, (M, K), generator=gen, device=dev, dtype=torch.int8)
        row = torch.randint(-127, 128, (K, N), generator=gen, device=dev, dtype=torch.int8)
        col = row.t().contiguous().t()  # the same matrix, column-major
        want = torch._int_mm(a, row)
        if not (torch.equal(torch._int_mm(a, col), want) and torch.equal(int_matmul(a, row), want)
                and torch.equal(int_matmul(a, col), want)):
            raise AssertionError(f"int8 products disagree at {(M, K, N)}")
        af, bf = a.to(torch.bfloat16), row.to(torch.bfloat16)
        t_row = _ms(lambda: torch._int_mm(a, row))
        t_col = _ms(lambda: torch._int_mm(a, col))
        t_copy = _ms(lambda: row.t().contiguous())
        t_port_row = _ms(lambda: int_matmul(a, row))
        t_port_col = _ms(lambda: int_matmul(a, col))
        t_bf16 = _ms(lambda: af @ bf)
        ops = 2.0 * M * K * N
        print(f"[{M},{K}]x[{K},{N}]: _int_mm b row-major {t_row:.4f} ms "
              f"({ops / t_row / 1e9:.0f} TOP/s), b column-major {t_col:.4f} ms "
              f"({ops / t_col / 1e9:.0f} TOP/s), layout copy {t_copy:.4f} ms; int_matmul "
              f"row-major {t_port_row:.4f} ms, column-major {t_port_col:.4f} ms; bf16 matmul "
              f"{t_bf16:.4f} ms ({ops / t_bf16 / 1e9:.0f} TFLOP/s)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
