"""Build, load and count the port's CUDA kernels.

Each source in ``csrc/`` is compiled on first use by ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface, one ``nvcc``
process per source, all started together, and loaded with ``ctypes``.
The libraries land in ``ops/_build/`` (listed in ``.gitignore``) under a
name that hashes the sources and flags, so a changed source is rebuilt and
an unchanged one is reused.  Nothing is built when this module is imported.

A library may export more than one kernel (``flash_decode.cu`` holds B4,
its f32 instance, its int8 variant B4q and their paged-cache instances B6
and B6q; ``flash_fwd_f32.cu`` is B1's f32 instance, a library of its own;
``chunk_decode.cu`` B5, B5q, B7 and B7q; ``int4_matmul.cu`` B8 alone):
``SOURCES`` names the libraries, ``_SIGNATURES`` each kernel's library,
symbol and argtypes.  The headers ``common.cuh`` and ``mma.cuh`` (cp.async,
ldmatrix and mma.sync helpers) are included by the sources and hashed into
every library's name.
``LAUNCHES`` counts the launches of each kernel; its wrapper adds one where
it launches, and nowhere else.  One C call may run more than one device
kernel: ``chunk_decode.cu``'s launchers run, when the columns are split
across blocks, a second kernel that merges the splits' partials, inside the
same call.  Each such call counts once.  (B8 and the one-token decode
kernel fold their split partials inside the one kernel: the last block of
a tile to finish sums them.)
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
SOURCES = {
    "flash_fwd": "flash_fwd.cu",
    "flash_fwd_f32": "flash_fwd_f32.cu",
    "flash_decode": "flash_decode.cu",
    "flash_bwd_dq": "flash_bwd_dq.cu",
    "flash_bwd_dkv": "flash_bwd_dkv.cu",
    "chunk_decode": "chunk_decode.cu",
    "int4_matmul": "int4_matmul.cu",
}
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_CHUNK_ARGS = [_P] * 9 + [_I] * 9 + [_LL] * 7 + [_F, _P]
_PAGED_CHUNK_ARGS = [_P] * 10 + [_I] * 11 + [_F, _P]
# kernel -> (library, launcher symbol, its argtypes) (csrc/*.cu, extern "C")
_SIGNATURES = {
    "flash_fwd": ("flash_fwd", "mmu_flash_fwd_bf16",
                  [_P] * 6 + [_I] * 6 + [_LL] * 12 + [_F, _I, _I, _P]),
    "flash_fwd_f32": ("flash_fwd_f32", "mmu_flash_fwd_f32",
                      [_P] * 6 + [_I] * 6 + [_LL] * 12 + [_F, _I, _I, _P]),
    "flash_decode": ("flash_decode", "mmu_flash_decode_bf16", [_P] * 7 + [_I] * 11 + [_F, _P]),
    "flash_decode_f32": ("flash_decode", "mmu_flash_decode_f32",
                         [_P] * 7 + [_I] * 11 + [_F, _P]),
    "flash_decode_q8": ("flash_decode", "mmu_flash_decode_q8", [_P] * 9 + [_I] * 11 + [_F, _P]),
    "flash_bwd_dq": ("flash_bwd_dq", "mmu_flash_bwd_dq_bf16",
                     [_P] * 8 + [_I] * 6 + [_LL] * 15 + [_F, _I, _I, _P]),
    "flash_bwd_dkv": ("flash_bwd_dkv", "mmu_flash_bwd_dkv_bf16",
                      [_P] * 9 + [_I] * 6 + [_LL] * 18 + [_F, _I, _I, _P]),
    "chunk_decode": ("chunk_decode", "mmu_chunk_decode_bf16", _CHUNK_ARGS),
    "chunk_decode_q8": ("chunk_decode", "mmu_chunk_decode_q8", _CHUNK_ARGS),
    "paged_decode": ("flash_decode", "mmu_paged_decode_bf16", [_P] * 8 + [_I] * 13 + [_F, _P]),
    "paged_decode_q8": ("flash_decode", "mmu_paged_decode_q8",
                        [_P] * 10 + [_I] * 13 + [_F, _P]),
    "paged_chunk": ("chunk_decode", "mmu_paged_chunk_bf16", _PAGED_CHUNK_ARGS),
    "paged_chunk_q8": ("chunk_decode", "mmu_paged_chunk_q8", _PAGED_CHUNK_ARGS),
    "int4_matmul": ("int4_matmul", "mmu_int4_matmul", [_P] * 6 + [_I] * 7 + [_P]),
}

LAUNCHES = {name: 0 for name in _SIGNATURES}

_lock = threading.Lock()
_launchers: dict[str, ctypes._CFuncPtr] = {}
_error_string = None


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    if Path("/usr/local/cuda/bin/nvcc").exists():
        return "/usr/local/cuda/bin/nvcc"
    raise RuntimeError("nvcc not found: the port's kernels are built with the CUDA toolkit")


def _library_path(name: str) -> Path:
    h = hashlib.sha256()
    for f in [SOURCES[name]] + sorted(p.name for p in CSRC.glob("*.cuh")):
        h.update((CSRC / f).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names=None) -> dict[str, float]:
    """Compile every named library (``SOURCES``) that is not built yet, one
    ``nvcc`` per source, all in parallel.  Returns the wall seconds each
    build took (0.0 for a library that was already there).  The compiler's
    register and shared-memory report (``-Xptxas -v``) is kept beside each
    library as ``<name>.log``."""
    names = list(SOURCES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs, took = {}, {}
    t0 = time.perf_counter()
    for name in names:
        out = _library_path(name)
        if out.exists():
            took[name] = 0.0
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        took[name] = time.perf_counter() - t0
        (BUILD_DIR / f"{name}.log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return took


def build_log(name: str) -> str:
    path = BUILD_DIR / f"{name}.log"
    return path.read_text() if path.exists() else ""


def launcher(name: str):
    """The C launcher of kernel ``name``, building its library on first use."""
    global _error_string
    fn = _launchers.get(name)
    if fn is not None:
        return fn
    with _lock:
        if name not in _launchers:
            lib_name, sym, argtypes = _SIGNATURES[name]
            path = _library_path(lib_name)
            if not path.exists():
                build([lib_name])
            lib = ctypes.CDLL(str(path))
            fn = getattr(lib, sym)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            if _error_string is None:
                _error_string = lib.mmu_error_string
                _error_string.argtypes = [ctypes.c_int]
                _error_string.restype = ctypes.c_char_p
            _launchers[name] = fn
    return _launchers[name]


_scratch: dict = {}


def fold_buffers(kind: str, device, numel: int, counters: int):
    """A persistent f32 workspace of at least ``numel`` elements and an
    int32 buffer of at least ``counters`` zeros on CUDA ``device``, for the
    kernels whose last block of a tile folds the tile's split partials
    (``kind`` names the kernel family).  The kernels leave every counter at
    0 and launches on one stream run in order, so one pair of buffers per
    (kind, device, current stream) serves every call there; launches on
    two streams never share one.  A larger request replaces the buffers."""
    import torch

    idx = device.index if device.index is not None else torch.cuda.current_device()
    key = (kind, idx, torch._C._cuda_getCurrentRawStream(idx))
    ws, cnt = _scratch.get(key, (None, None))
    if ws is None or ws.numel() < numel:
        ws = torch.empty(max(numel, 1 << 16), dtype=torch.float32, device=device)
    if cnt is None or cnt.numel() < counters:
        cnt = torch.zeros(max(counters, 1024), dtype=torch.int32, device=device)
    _scratch[key] = (ws, cnt)
    return ws, cnt


def run(name: str, device, *args) -> None:
    """Launch kernel ``name`` on the current stream of CUDA ``device`` with
    ``args`` (its launcher's arguments but the stream), raise if the launch
    failed, and count it.  The device is made current only for a launch
    that needs it (a device context costs microseconds of host time on
    every call)."""
    import torch

    fn = launcher(name)
    idx = device.index if device.index is not None else torch.cuda.current_device()
    if idx == torch.cuda.current_device():
        err = fn(*args, torch._C._cuda_getCurrentRawStream(idx))
    else:
        with torch.cuda.device(idx):
            err = fn(*args, torch._C._cuda_getCurrentRawStream(idx))
    check(name, err)
    LAUNCHES[name] += 1


def check(name: str, err: int) -> None:
    """Raise if a launcher reported a CUDA error (a refused launch never
    runs, and a later synchronize would not report it)."""
    if err != 0:
        msg = _error_string(err).decode() if _error_string is not None else ""
        raise RuntimeError(f"kernel {name} failed to launch: CUDA error {err} {msg}")
