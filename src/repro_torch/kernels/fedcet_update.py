"""CUDA kernels for the FedCET update hot path (port of
``src/repro/kernels/fedcet_update.py``).

The kernels live in ``csrc/fedcet_update.cu`` behind a plain C interface.
On first use they are compiled from that source with ``nvcc`` for
``sm_90a`` into ``build/torch_kernels/`` under the checkout (named by a
hash of the source and flags, so an edited source rebuilds) and loaded
with ``ctypes``. Nothing is built or loaded at import time.

The wrappers check device, dtype, contiguity and shape, allocate their
outputs with ``torch.empty``, launch on PyTorch's current stream and raise
if the launch reports an error. Each wrapper counts its launches in
:data:`LAUNCHES`, so a run can show that it went through the kernels.
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

import torch

SOURCE = Path(__file__).resolve().parent / "csrc" / "fedcet_update.cu"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-shared", "-Xcompiler", "-fPIC")

#: launches per wrapper (plain integers; reset with :func:`reset_launches`).
LAUNCHES = {"fedcet_v": 0, "fedcet_comm": 0}

_LIB = None
_LOCK = threading.Lock()


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def build_dir() -> Path:
    """``build/torch_kernels`` at the root of the checkout."""
    return Path(__file__).resolve().parents[3] / "build" / "torch_kernels"


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the FedCET CUDA kernels are built "
                       "from source on first use and need the CUDA toolkit")


def build(verbose: bool = False) -> tuple[Path, float, str]:
    """Compile ``csrc/fedcet_update.cu`` unless a library built from the
    same source and flags exists. Returns ``(library path, seconds spent
    compiling, compiler output)``; seconds is 0.0 on a cache hit."""
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = build_dir() / f"libfedcet_update_{digest}.so"
    if out.exists():
        return out, 0.0, ""
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", str(tmp), str(SOURCE)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    return out, seconds, proc.stdout + proc.stderr


def _library():
    global _LIB
    with _LOCK:
        if _LIB is None:
            path, _, _ = build()
            lib = ctypes.CDLL(str(path))
            ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
            for name, scalar in (("f32", ctypes.c_float),
                                 ("f64", ctypes.c_double)):
                fv = getattr(lib, f"fedcet_v_{name}")
                fv.argtypes = [ptr, ptr, ptr, ptr, scalar, i64, i32, ptr]
                fv.restype = i32
                fc = getattr(lib, f"fedcet_comm_{name}")
                fc.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, scalar, scalar,
                               i64, i64, i32, ptr]
                fc.restype = i32
            _LIB = lib
        return _LIB


_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def _check(name: str, *tensors: torch.Tensor) -> str:
    dev, dt = tensors[0].device, tensors[0].dtype
    if dev.type != "cuda":
        raise ValueError(f"{name}: the CUDA kernel needs CUDA tensors, got "
                         f"{dev}")
    if dt not in _SUFFIX:
        raise TypeError(f"{name}: float32 or float64 only, got {dt}")
    for t in tensors:
        if t.device != dev or t.dtype != dt:
            raise ValueError(f"{name}: operands differ in device or dtype "
                             f"({t.device}, {t.dtype} vs {dev}, {dt})")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
    return _SUFFIX[dt]


def _aligned(*tensors: torch.Tensor) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err} "
                           f"({torch.cuda.get_device_name()})")


def fedcet_v(x: torch.Tensor, g: torch.Tensor, d: torch.Tensor,
             alpha: float) -> torch.Tensor:
    """``x - alpha*g - alpha*d`` in one kernel pass over any leaf shape
    (a whole stacked ``[clients, ...]`` leaf is one launch)."""
    sfx = _check("fedcet_v", x, g, d)
    if g.shape != x.shape or d.shape != x.shape:
        raise ValueError(f"fedcet_v: shapes differ {x.shape} {g.shape} "
                         f"{d.shape}")
    out = torch.empty_like(x)
    n = x.numel()
    if n == 0:
        return out
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = getattr(lib, f"fedcet_v_{sfx}")(
            x.data_ptr(), g.data_ptr(), d.data_ptr(), out.data_ptr(), alpha,
            n, int(_aligned(x, g, d, out)), stream)
    _raise_on(err, "fedcet_v")
    LAUNCHES["fedcet_v"] += 1
    return out


def fedcet_comm(d: torch.Tensor, m: torch.Tensor, m_bar: torch.Tensor,
                c: float, alpha: float, v: torch.Tensor | None = None):
    """The paired aggregation ``(d + c*delta, v - c*alpha*delta)`` with
    ``delta = m - m_bar``, both outputs in one kernel visit. ``d``, ``m``
    (and ``v``) are ``[clients, ...]``; ``m_bar`` is the ``[1, ...]`` client
    mean (or has ``m``'s shape, then read as one client) and is never
    expanded. ``v=None`` is the 3-operand form (``v = m``)."""
    ops = (d, m, m_bar) if v is None else (d, m, m_bar, v)
    sfx = _check("fedcet_comm", *ops)
    if d.shape != m.shape or (v is not None and v.shape != m.shape):
        raise ValueError(f"fedcet_comm: d, m, v shapes differ {d.shape} "
                         f"{m.shape} {None if v is None else v.shape}")
    if m_bar.shape == m.shape:
        clients, p = 1, m.numel()
    elif m.dim() >= 1 and m_bar.shape == (1,) + tuple(m.shape[1:]):
        clients, p = m.shape[0], m_bar.numel()
    else:
        raise ValueError(f"fedcet_comm: m_bar must be [1, ...] of m's "
                         f"trailing shape or m's shape, got {m_bar.shape} "
                         f"for m {m.shape}")
    d_out, x_out = torch.empty_like(d), torch.empty_like(m)
    if m.numel() == 0:
        return d_out, x_out
    width = 16 // m.element_size()
    vec = _aligned(*ops, d_out, x_out) and p % width == 0
    lib = _library()
    with torch.cuda.device(m.device):
        stream = torch.cuda.current_stream(m.device).cuda_stream
        err = getattr(lib, f"fedcet_comm_{sfx}")(
            d.data_ptr(), m.data_ptr(), m_bar.data_ptr(),
            None if v is None else v.data_ptr(), d_out.data_ptr(),
            x_out.data_ptr(), c, c * alpha, clients, p, int(vec), stream)
    _raise_on(err, "fedcet_comm")
    LAUNCHES["fedcet_comm"] += 1
    return d_out, x_out
