"""ECO embedding-corruption library: the port's counterpart of
``multimodal_unlearning_tpu/methods/eco/corrupt.py`` (reference:
methods/eco/corrupt.py:4-253).

All 14 operations as functions on tensors: each maps ``(data [B,S,D],
pos [B,S], dims, strength, key)`` to new data, applied only where ``pos``
marks attack tokens.  Randomness is an explicit key, as in the JAX package:
a threefry key ``[2]`` (int64 words holding uint32 values), drawn through
the port's own copy of the threefry2x32 hash (``evaluation/sampling.py``).
``split``, the random bits, the uniforms and ``permutation`` give
``jax.random``'s values bit for bit (its partitionable threefry, the
default); ``normal`` is ``sqrt(2) erfinv(u)`` of those uniforms through
XLA's erfinv polynomial, whose ``log1p`` and products may round their last
bits unlike XLA's (the noise agrees to ~5e-7).
"""

from __future__ import annotations

import math

import torch

from multimodal_unlearning_tpu_torch.evaluation.sampling import fold_in, random_bits

__all__ = ["corrupt_methods", "prng_key", "split", "normal", "permutation"]


# ------------------------------------------------------------- keys
def prng_key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)``: the words (seed >> 32, seed & 0xFFFFFFFF)."""
    seed = int(seed)
    return torch.tensor([(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF], dtype=torch.int64,
                        device=device)


def split(key, num: int = 2) -> list[torch.Tensor]:
    """``jax.random.split(key, num)``: key i is the hash of the counter pair
    (0, i), i.e. ``fold_in(key, i)``."""
    keys = fold_in(key[None].expand(num, 2), torch.arange(num, device=key.device))
    return list(keys.unbind(0))


def _bits(key, shape) -> torch.Tensor:
    """``jax.random.bits(key, shape)`` (32 bits per entry, row-major over
    ``shape``) as int64."""
    n = math.prod(shape)
    return random_bits(key[None], n)[0].reshape(shape)


def _uniform(key, shape, lo: float, hi: float) -> torch.Tensor:
    """``jax.random.uniform(key, shape, f32, lo, hi)``."""
    bits = (_bits(key, shape) >> 9) | 0x3F800000
    f = bits.to(torch.int32).view(torch.float32) - 1.0
    lo_t = torch.tensor(lo, dtype=torch.float32, device=key.device)
    hi_t = torch.tensor(hi, dtype=torch.float32, device=key.device)
    return torch.maximum(lo_t, f * (hi_t - lo_t) + lo_t)


_NEXT_ABOVE_MINUS_ONE = float(torch.nextafter(torch.tensor(-1.0), torch.tensor(0.0)))
# Giles' single-precision erfinv polynomials, as XLA expands ``erf_inv``:
# coefficients for w = -log1p(-x^2) below 5 and at or above it
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
               0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
               0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def _erfinv(x):
    """erfinv of f32 ``x`` in (-1, 1) by XLA's polynomial (torch's own
    ``erfinv`` rounds differently: up to 2e-5 apart from JAX's normals)."""
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    p = torch.where(lt, _ERFINV_LT5[0], _ERFINV_GE5[0])
    for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = torch.where(lt, a, b) + p * w
    return p * x


def normal(key, shape, dtype=torch.float32) -> torch.Tensor:
    """``jax.random.normal(key, shape, dtype)``: sqrt(2) erfinv(u), u
    uniform on (-1, 1), computed in f32."""
    u = _uniform(key, shape, _NEXT_ABOVE_MINUS_ONE, 1.0)
    return (_erfinv(u) * math.sqrt(2.0)).to(dtype)


def permutation(key, n: int) -> torch.Tensor:
    """``jax.random.permutation(key, n)``: arange(n) sorted by fresh 32-bit
    keys, ``ceil(3 ln n / ln(2^32 - 1))`` rounds of a stable sort."""
    x = torch.arange(n, device=key.device)
    rounds = math.ceil(3 * math.log(max(1, n)) / math.log(2 ** 32 - 1))
    for _ in range(rounds):
        key, sub = split(key)
        order = torch.sort(_bits(sub, (n,)), stable=True).indices
        x = x[order]
    return x


# ------------------------------------------------------------- masks
def _mask3(data, pos):
    return pos.to(torch.bool, copy=False).to(data.device)[..., None]


def _first_n_mask(data, dims):
    d = torch.arange(data.shape[-1], device=data.device) < dims
    return d[None, None, :]


def _topk_mask(data, dims, largest=True, by_abs=True):
    """Boolean mask of the per-position top-k (|value| by default): every
    entry at or past the k-th value, so ties at it select more than k."""
    v = data.abs() if by_abs else data
    v = v if largest else -v
    kth = torch.sort(v, dim=-1).values[..., -dims]
    return v >= kth[..., None]


def _zero(data):
    return torch.zeros((), dtype=data.dtype, device=data.device)


# ------------------------------------------------------------- operations
def rand_noise_first_n(data, pos, dims, strength, key):
    noise = normal(key, data.shape, data.dtype) * strength
    m = _mask3(data, pos) & _first_n_mask(data, dims)
    return data + torch.where(m, noise, _zero(data))


def rand_noise_rand_n(data, pos, dims, strength, key):
    k1, k2 = split(key)
    sel = permutation(k1, data.shape[-1])[:dims]
    dim_mask = torch.zeros(data.shape[-1], dtype=torch.bool, device=data.device)
    dim_mask[sel] = True
    noise = normal(k2, data.shape, data.dtype) * strength
    return data + torch.where(_mask3(data, pos) & dim_mask[None, None, :], noise, _zero(data))


def rand_noise_top_k(data, pos, dims, strength, key):
    noise = normal(key, data.shape, data.dtype) * strength
    m = _mask3(data, pos) & _topk_mask(data, dims)
    return data + torch.where(m, noise, _zero(data))


def zero_out_top_k(data, pos, dims, strength=None, key=None):
    m = _mask3(data, pos) & _topk_mask(data, dims)
    return torch.where(m, _zero(data), data)


def zero_out_first_n(data, pos, dims, strength=None, key=None):
    m = _mask3(data, pos) & _first_n_mask(data, dims)
    return torch.where(m, _zero(data), data)


def flip_sign_first_n(data, pos, dims, strength=None, key=None):
    m = _mask3(data, pos) & _first_n_mask(data, dims)
    return torch.where(m, -data, data)


def flip_sign_top_k(data, pos, dims, strength=None, key=None):
    m = _mask3(data, pos) & _topk_mask(data, dims)
    return torch.where(m, -data, data)


def sub_value_top_k(data, pos, dims, strength, key=None):
    m = _mask3(data, pos) & _topk_mask(data, dims, by_abs=False)  # largest values
    return torch.where(m, data - strength, data)


def add_value_least_k(data, pos, dims, strength, key=None):
    m = _mask3(data, pos) & _topk_mask(data, dims, largest=False, by_abs=False)
    return torch.where(m, data + strength, data)


def sub_value_first_n(data, pos, dims, strength, key=None):
    m = _mask3(data, pos) & _first_n_mask(data, dims)
    return torch.where(m, data - strength, data)


def add_value_first_n(data, pos, dims, strength, key=None):
    m = _mask3(data, pos) & _first_n_mask(data, dims)
    return torch.where(m, data + strength, data)


def set_rand_noise_first_n(data, pos, dims, strength, key):
    """The reference assigns its noise buffer into ``data[:, :, :dims]`` for
    ALL positions (corrupt.py:214): attack positions get the noise, every
    other position the buffer's zeros -- the rows that are not attacked are
    zeroed in the first dims too.  Kept, as in the JAX package."""
    noise = normal(key, data.shape, data.dtype) * strength
    fn = _first_n_mask(data, dims)
    pm = _mask3(data, pos)
    return torch.where(fn, torch.where(pm, noise, _zero(data)), data)


def reverse_order(data, pos=None, dims=None, strength=None, key=None):
    return torch.flip(data, dims=(1,))


def shuffle(data, pos=None, dims=None, strength=None, key=None):
    order = permutation(key, data.shape[1])
    return data[:, order.to(data.device), :]


corrupt_methods = {
    "rand_noise_first_n": rand_noise_first_n,
    "rand_noise_top_k": rand_noise_top_k,
    "zero_out_top_k": zero_out_top_k,
    "flip_sign_first_n": flip_sign_first_n,
    "flip_sign_top_k": flip_sign_top_k,
    "sub_value_top_k": sub_value_top_k,
    "add_value_least_k": add_value_least_k,
    "set_rand_noise_first_n": set_rand_noise_first_n,
    "rand_noise_rand_n": rand_noise_rand_n,
    "zero_out_first_n": zero_out_first_n,
    "reverse_order": reverse_order,
    "shuffle": shuffle,
    "sub_value_first_n": sub_value_first_n,
    "add_value_first_n": add_value_first_n,
}
