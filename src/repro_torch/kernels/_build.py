"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` exposes a plain C interface and compiles on first
use into ``build/repro_torch/<name>-<hash>.so`` at the root of the
checkout, keyed by a hash of the source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited source rebuilds and an
unchanged one loads straight away.  ptxas's report (registers, shared
memory, spills per kernel) is kept beside the library as ``<stem>.log``.
A failed build raises with nvcc's stderr; nothing falls back to another
implementation.  :func:`build_all` starts one nvcc per source at once.

:func:`launch` is the launch path of the wrappers: it calls a C entry
point on the current stream of a device at the least host cost the
binding allows (no stream object, no device switch when the device is
already current).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, List, Optional

import torch

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

_P, _I, _LL, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_float)

# argtypes/restype of each library's C entry points: pointers and the
# stream as c_void_p (a plain int would be cut to 32 bits)
_SIGNATURES = {
    "finish_batch": {
        "finish_batch_launch": ([_P, _P, _LL, _P], _I),
        "finish_batch_device_ptr": ([_P, ctypes.POINTER(_P)], _I),
        "finish_batch_sync": ([_P], _I),
    },
    "rmsnorm": {
        # x, scale, out, m, d, eps, x_dtype, scale_dtype, vec, stream
        "rmsnorm_launch": ([_P, _P, _P, _LL, _I, _F, _I, _I, _I, _P], _I),
    },
    "fused_ffn": {
        # x, wg, wi, wo, h, out, ws, ws bytes, m, d, f, dtype, stream
        "fused_ffn_launch": ([_P] * 7 + [_LL, _LL, _I, _I, _I, _P], _I),
        # m, d, f, dtype -> workspace bytes (or minus a cudaError_t)
        "fused_ffn_workspace": ([_LL, _I, _I, _I], _LL),
    },
    "flash_attention": {
        # q, k, v, o, B, H, Hkv, S, dqk, dv, the b/h/s strides of q, k, v
        # and o, causal, window, scale, dtype, stream
        "flash_attention_launch": ([_P] * 4 + [_I] * 6 + [_LL] * 12
                                   + [_I, _I, _F, _I, _P], _I),
    },
    "mla_decode": {
        # q_lat, q_rope, ckv, k_rope, positions, o, ws, B, H, T, kvr, rope,
        # splits, the b/h strides of q_lat and q_rope, the b/t strides of
        # ckv and k_rope, the b stride of positions, the b/h strides of o,
        # scale, stream
        "mla_decode_launch": ([_P] * 7 + [_I] * 6 + [_LL] * 11 + [_F, _P],
                              _I),
    },
}

#: dtype codes of the C entry points (``DT_F32``/``DT_BF16`` in
#: ``csrc/tile_mma.cuh``)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_LOADED: Dict[str, ctypes.CDLL] = {}
# held while a library is built and loaded: threads that ask for the same
# library at once (the plan server's search workers) build it once
_LOAD_LOCK = threading.Lock()

# the current device and a device's current stream, read straight from
# torch's C bindings (a CPU-only build has neither, and launches nothing)
_GET_DEVICE = getattr(torch._C, "_cuda_getDevice", None)
_RAW_STREAM = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def find_nvcc() -> Optional[str]:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on ``PATH``, else the
    toolkit's default install path; ``None`` when there is none."""
    candidates: List[str] = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for path in candidates:
        if os.path.isfile(path) and os.access(path, os.X_OK):
            return path
    return None


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to (content-addressed)."""
    src = CSRC_DIR / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library is already built."""
    return build_all([name])[name]


def build_all(names: Iterable[str]) -> Dict[str, Path]:
    """Compile every named source that is not built yet, one ``nvcc`` each,
    all started together; returns each library's path.  Any failed build
    raises with its stderr once all have finished."""
    outs = {name: library_path(name) for name in names}
    todo = {name: out for name, out in outs.items() if not out.is_file()}
    if not todo:
        return outs
    nvcc = find_nvcc()
    if nvcc is None:
        raise RuntimeError(
            f"cannot build the {', '.join(todo)} CUDA kernel(s): nvcc not "
            f"found (set $CUDA_HOME or put nvcc on PATH)")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, out in todo.items():
        # build under a name private to this process and thread, then
        # rename: concurrent builders never load a half-written library
        tmp = out.with_name(
            f"{out.stem}.{os.getpid()}.{threading.get_ident()}.tmp.so")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC_DIR), "-o", str(tmp),
               str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (tmp, cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    failures = []
    for name, (tmp, cmd, proc) in procs.items():
        _, stderr = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failures.append(f"nvcc failed to build {name} (exit "
                            f"{proc.returncode}):\n{' '.join(cmd)}\n{stderr}")
            continue
        todo[name].with_suffix(".log").write_text(stderr)
        os.replace(tmp, todo[name])
    if failures:
        raise RuntimeError("\n".join(failures))
    return outs


def ptxas_report(name: str) -> str:
    """What ptxas said when ``csrc/<name>.cu`` was built (registers, shared
    memory and spills per kernel); empty if the library was not built."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.is_file() else ""


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``, with typed entry
    points; built and loaded once per process, whatever the number of
    threads that ask for it."""
    lib = _LOADED.get(name)
    if lib is not None:
        return lib
    with _LOAD_LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            for fn, (argtypes, restype) in _SIGNATURES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = restype
            _LOADED[name] = lib
    return lib


def check_cuda_tensors(name: str, *tensors, contiguous: bool = True) -> int:
    """Raise ``ValueError`` unless every tensor lies on one CUDA device
    (and, with ``contiguous``, is contiguous): the kernels take nothing
    else.  Raise ``RuntimeError`` if grad is enabled and one requires
    grad: the kernel's output would have no ``grad_fn`` and silently cut
    the graph (:mod:`repro_torch.kernels.ops` routes such calls through
    the kernels' autograd Functions).  Returns that device's index."""
    index = tensors[0].get_device()
    grad = torch.is_grad_enabled()
    for t in tensors:
        if not t.is_cuda or t.get_device() != index:
            raise ValueError(f"{name} runs on tensors of one CUDA device, "
                             f"got {[str(x.device) for x in tensors]}")
        if contiguous and not t.is_contiguous():
            raise ValueError(f"{name} expects contiguous tensors")
        if grad and t.requires_grad:
            raise RuntimeError(
                f"{name} was called on a tensor that requires grad with "
                f"grad enabled: its output would carry no grad_fn; call "
                f"repro_torch.kernels.ops (autograd) or use torch.no_grad()")
    return index


def dtype_code(name: str, t) -> int:
    """The C entry points' code for ``t``'s dtype (fp32 or bf16), looked up
    by the ``torch.dtype`` object."""
    code = DTYPE_CODES.get(t.dtype)
    if code is None:
        raise ValueError(f"{name} takes float32 or bfloat16, not {t.dtype}")
    return code


def current_stream(index: int) -> int:
    """The raw handle of the current stream of CUDA device ``index``, read
    without building a ``torch.cuda.Stream`` object."""
    return _RAW_STREAM(index)


def query(entry, index: int, *args):
    """``entry(*args)`` on CUDA device ``index`` (made current for the call
    only if it is not already); its return value."""
    if _GET_DEVICE() == index:
        return entry(*args)
    with torch.cuda.device(index):
        return entry(*args)


def launch(entry, index: int, *args) -> None:
    """Call the C entry point ``entry(*args, stream)`` with the current
    stream of CUDA device ``index``, on that device: made current for the
    call only if it is not already.  Raises ``RuntimeError`` if the entry
    returns a nonzero ``cudaError_t``."""
    if _GET_DEVICE() == index:
        err = entry(*args, _RAW_STREAM(index))
    else:
        with torch.cuda.device(index):
            err = entry(*args, _RAW_STREAM(index))
    if err != 0:
        raise RuntimeError(f"{entry.__name__} failed: cudaError_t {err}")
