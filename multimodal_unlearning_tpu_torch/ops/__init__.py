"""Attention operators: plain PyTorch versions and hand-written CUDA kernels.

Each operator takes its plain version for a tensor on the CPU and launches
its kernel (``csrc/``) for a tensor on the card; there is no other route.
"""
