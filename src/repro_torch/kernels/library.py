"""Build, load and bookkeeping shared by the port's CUDA kernels.

Every ``csrc/*.cu`` source (with the ``csrc/*.cuh`` headers they include)
compiles into ONE shared library with a plain C interface, loaded with
``ctypes``. On first use the sources are compiled with ``nvcc`` for
``sm_90a``, one ``nvcc`` process per source, all started together, then
linked, into ``build/torch_kernels/`` under the checkout. The library is
named by a hash over all sources, headers and flags, so editing any of
them rebuilds it. Nothing is built or loaded at import time.

Each kernel wrapper (``kernels/fedcet_update.py``, ``kernels/quantize.py``,
``kernels/gossip_reduce.py``, ``kernels/telemetry_reduce.py``,
``kernels/flash_attention.py``, ``kernels/ssd_intra.py``,
``kernels/threefry.py``) checks device,
dtype, contiguity and shape, allocates its outputs with ``torch.empty``,
launches on PyTorch's current stream, raises if the launch reports an
error, and adds one to its entry of :data:`LAUNCHES`.
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

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = tuple(sorted(CSRC.glob("*.cu")))
HEADERS = tuple(sorted(CSRC.glob("*.cuh")))
#: --fmad=false: products and sums round once each, like the plain PyTorch
#: expressions, so the card checks can hold a tolerance of 0. The flash
#: attention and SSD kernels, held to tolerances instead, sum their
#: products on the tensor cores (3xTF32 in float32).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-Xcompiler", "-fPIC")

#: launches per kernel form (plain integers; reset with reset_launches()).
LAUNCHES = {"fedcet_v": 0, "fedcet_comm": 0, "fedcet_comm4": 0,
            "stochastic_quantize": 0, "stochastic_quantize_rows": 0,
            "fedcet_round_tail": 0, "gossip_reduce": 0,
            "telemetry_sketch": 0, "flash_attention": 0, "ssd_intra": 0,
            "threefry_uniform_rows": 0}

_LIB = None
_LOCK = threading.Lock()

_ptr, _i64, _i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_u32 = ctypes.c_uint32
#: C entry points: name -> argtypes, with "T" for the float of the suffix.
_SIGNATURES = {
    "fedcet_v": [_ptr] * 4 + ["T", _i64, _i32, _ptr],
    "fedcet_comm": [_ptr] * 6 + ["T", "T", _i64, _i64, _i32, _ptr],
    "fedcet_round_tail": ([_ptr] * 10 + ["T", "T", "T", _i32, _i64, _i64,
                                         _i64, _i32, _ptr]),
    "stochastic_quantize": [_ptr] * 4 + [_i32, _i64, _i64, _i64, _i32, _i32,
                                         _ptr],
    "gossip_reduce": [_ptr] * 5 + [_i64] * 4 + [_i32, _ptr],
    "telemetry_sketch": [_ptr] * 4 + [_i64, _i64, _i32, _i32, "T", "T", _i32,
                                      _ptr],
    "flash_attention": [_ptr] * 4 + [_i64] * 3 + [_i32] * 6 + [_ptr],
    "ssd_intra": [_ptr] * 6 + [_i64] + [_i32] * 5 + [_ptr],
    "threefry_uniform_rows": [_ptr] * 3 + [_u32, _u32, _i64, _i64, _ptr],
}
#: the float types each entry point is built for (default: f32 and f64).
_BUILT_FOR = {"flash_attention": ("f32", "bf16"),
              "ssd_intra": ("f32", "bf16")}
#: counted forms that share another form's C entry point.
_ENTRY = {"fedcet_comm4": "fedcet_comm",
          "stochastic_quantize_rows": "stochastic_quantize"}
#: C functions without a float type: name -> (argtypes, restype).
_QUERIES = {"gossip_reduce_column_rows": ([_i64, _i64, _i32, _i32], _i64)}
SUFFIX = {torch.float32: "f32", torch.float64: "f64", torch.bfloat16: "bf16"}
_CTYPE = {"f32": ctypes.c_float, "f64": ctypes.c_double}


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
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                       "from source on first use and need the CUDA toolkit")


def build(verbose: bool = False) -> tuple[Path, float, str]:
    """Compile and link every ``csrc/*.cu`` unless a library built from the
    same sources, headers and flags exists. Returns ``(library path,
    seconds spent building, compiler output)``; seconds is 0.0 on a cache
    hit. ``verbose`` adds ``-Xptxas -v`` (registers and spills per
    kernel) to the output."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in SOURCES + HEADERS:
        h.update(f.name.encode() + b"\0" + f.read_bytes())
    out = build_dir() / f"libreprotorch_{h.hexdigest()[:16]}.so"
    if out.exists():
        return out, 0.0, ""
    out.parent.mkdir(parents=True, exist_ok=True)
    nvcc, tag = _nvcc(), f"{os.getpid()}.tmp"
    extra = ["-Xptxas", "-v"] if verbose else []
    t0 = time.perf_counter()
    objs = [out.parent / f"{src.stem}.{tag}.o" for src in SOURCES]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, *extra, "-c", "-o", str(o),
                               str(src)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for src, o in zip(SOURCES, objs)]
    logs = []
    for src, proc in zip(SOURCES, procs):
        text, _ = proc.communicate()
        logs.append(f"== {src.name}\n{text}")
        if proc.returncode != 0:
            for p in procs:
                p.wait()
            raise RuntimeError(f"nvcc failed on {src.name} "
                               f"({proc.returncode}):\n{text}")
    tmp = out.with_suffix(f".{tag}")
    link = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
                           *map(str, objs)], capture_output=True, text=True)
    for o in objs:
        o.unlink(missing_ok=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({link.returncode}):\n"
                           f"{link.stderr}")
    os.replace(tmp, out)
    return out, time.perf_counter() - t0, "\n".join(logs)


def library():
    """The loaded kernel library (built on first call)."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            path, _, _ = build()
            lib = ctypes.CDLL(str(path))
            for name, sig in _SIGNATURES.items():
                for sfx in _BUILT_FOR.get(name, ("f32", "f64")):
                    fn = getattr(lib, f"{name}_{sfx}")
                    fn.argtypes = [_CTYPE[sfx] if a == "T" else a
                                   for a in sig]
                    fn.restype = _i32
            for name, (argtypes, restype) in _QUERIES.items():
                fn = getattr(lib, name)
                fn.argtypes, fn.restype = argtypes, restype
            _LIB = lib
        return _LIB


def check(name: str, *tensors: torch.Tensor) -> str:
    """Device, dtype and contiguity checks; returns the entry-point suffix."""
    dev, dt = tensors[0].device, tensors[0].dtype
    if dev.type != "cuda":
        raise ValueError(f"{name}: the CUDA kernel needs CUDA tensors, got "
                         f"{dev}")
    built = _BUILT_FOR.get(name, ("f32", "f64"))
    if SUFFIX.get(dt) not in built:
        names = [str(t)[6:] for t, sfx in SUFFIX.items() if sfx in built]
        raise TypeError(f"{name}: {' or '.join(names)} only, got {dt}")
    for t in tensors:
        if t.device != dev or t.dtype != dt:
            raise ValueError(f"{name}: operands differ in device or dtype "
                             f"({t.device}, {t.dtype} vs {dev}, {dt})")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
    return SUFFIX[dt]


def aligned(*tensors: torch.Tensor) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def launch(name: str, sfx: str, like: torch.Tensor, *args) -> None:
    """Call ``name_sfx`` on the current stream of ``like``'s device, raise
    if the launch fails, and count it under ``name`` in :data:`LAUNCHES`
    (the C entry point's name for all but the counted form)."""
    fn = getattr(library(), f"{_ENTRY.get(name, name)}_{sfx}")
    with torch.cuda.device(like.device):
        stream = torch.cuda.current_stream(like.device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err} "
                           f"({torch.cuda.get_device_name(like.device)})")
    LAUNCHES[name] += 1
