"""Build and bind the hand-written CUDA kernels in ``repro_torch/csrc``.

Each ``csrc/<name>.cu`` has a plain C interface. It is compiled with
``nvcc`` on first use into ``build/repro_torch_kernels/`` at the root of
the checkout (``.gitignore`` lists ``build/``), as
``lib<name>-<hash>.so`` where the hash covers the source and the flags,
and loaded with ``ctypes``. ``build()`` compiles several sources at once,
one ``nvcc`` each, all started together. A library named ``<name>@<k>``
is ``csrc/<name>.cu`` built with ``-DVARIANT=<k>``: K4's source is built
once per law (``fused_tick@<law id>``), since one ``nvcc`` for all its
laws' instantiations took longer than every other source together.

``-fmad=false``: the plain versions (``kernels/ref.py``) round every
product before the add, as ``repro`` does with ``laws._nofma``; an FMA
would move the law kernels off them. The LM kernels (K5, K6) are built
the same way.

``counters`` hands a kernel that combines across blocks its per-device
block of zeroed election counters (the electing block resets its own).

``LAUNCHES`` counts the launches of each kernel; a wrapper adds one
where it launches its kernel and nowhere else, so a run can show that it
went through the kernels (``reset_launches`` zeroes the counts).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
# K4's laws: kernels/fused_tick.py::LAW_NAMES (a test holds the count)
K4_VARIANTS = 13
SOURCES = ("powertcp_step", "queue_arrivals",
           *(f"fused_tick@{i}" for i in range(K4_VARIANTS)), "rmsnorm",
           "flash_attention")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

LAUNCHES = {"powertcp_step": 0, "theta_powertcp_step": 0,
            "powertcp_observe_step": 0, "theta_powertcp_observe_step": 0,
            "queue_arrivals": 0, "fused_tick_block": 0, "rmsnorm": 0,
            "flash_attention": 0}

_LIBS: dict = {}
_COUNTERS: dict = {}
_LOCK = threading.Lock()


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch "
                           "are built with the CUDA toolkit's nvcc")
    return path


def _source(name: str):
    """(``csrc`` source, extra nvcc flags) of library ``name``."""
    base, _, variant = name.partition("@")
    return CSRC / f"{base}.cu", ((f"-DVARIANT={variant}",) if variant
                                  else ())


def library_path(name: str) -> Path:
    src, extra = _source(name)
    digest = hashlib.sha256(src.read_bytes() + " ".join(
        NVCC_FLAGS + extra).encode()).hexdigest()
    return BUILD / f"lib{name.replace('@', '_')}-{digest[:16]}.so"


def build(names=SOURCES) -> dict:
    """Compile every library in ``names`` that is not built yet, one
    ``nvcc`` per source, all at once. Returns ``{name: compiler output}``
    for the sources compiled (the ``-Xptxas -v`` register and spill
    report); raises with the compiler output if any build fails."""
    BUILD.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    jobs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        src, extra = _source(name)
        cmd = [nvcc, *NVCC_FLAGS, *extra, "-o", str(tmp), str(src)]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in jobs.items():
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode != 0:
            failed.append(name)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def library(name: str, signatures: dict) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (built if needed), with
    ``argtypes`` set from ``signatures`` ({function: [ctypes types]}) and
    every function returning its ``cudaError_t`` as an int."""
    lib = _LIBS.get(name)
    if lib is None:
        with _LOCK:
            lib = _LIBS.get(name)
            if lib is None:
                build((name,))
                lib = ctypes.CDLL(str(library_path(name)))
                for fn, argtypes in signatures.items():
                    getattr(lib, fn).argtypes = argtypes
                    getattr(lib, fn).restype = ctypes.c_int
                _LIBS[name] = lib
    return lib


def counters(name: str, n: int, device) -> torch.Tensor:
    """At least ``n`` int32 election counters for kernel ``name`` on
    ``device``, all zero between launches: made zeroed on first use (or
    when more are needed) and kept, since each kernel's electing block
    sets its counter back to 0. Launches of one kernel on one device share
    them, so they must not run concurrently on two streams."""
    key = (name, str(device))
    cnt = _COUNTERS.get(key)
    if cnt is None or cnt.numel() < n:
        cnt = torch.zeros(max(n, 64), dtype=torch.int32, device=device)
        _COUNTERS[key] = cnt
    return cnt


def check(err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")


def check_tensors(what: str, tensors: dict, shapes: dict, device,
                  dtypes: dict = None) -> None:
    """Validate what a kernel takes: every tensor on ``device`` (a CUDA
    device), contiguous, with its dtype (``dtypes[key]``; by default
    float32, or bool for the masks ``valid`` and ``upd``) and shape."""
    if device.type != "cuda":
        raise ValueError(f"{what}: the CUDA kernel takes CUDA tensors, got "
                         f"{device}")
    for key, x in tensors.items():
        want = (dtypes or {}).get(key) or (
            torch.bool if key in ("valid", "upd") else torch.float32)
        if x.device != device:
            raise ValueError(f"{what}: {key} is on {x.device}, not {device}")
        if x.dtype != want:
            raise TypeError(f"{what}: {key} has dtype {x.dtype}, not {want}")
        if tuple(x.shape) != shapes[key]:
            raise ValueError(f"{what}: {key} has shape {tuple(x.shape)}, "
                             f"not {shapes[key]}")
        if not x.is_contiguous():
            raise ValueError(f"{what}: {key} is not contiguous")
