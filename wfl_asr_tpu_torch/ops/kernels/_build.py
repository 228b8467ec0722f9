"""Build the CUDA sources under ``csrc/`` with ``nvcc`` and bind them by ctypes.

Each ``csrc/<name>.cu`` exposes ``extern "C"`` launchers that take raw
device pointers and a ``cudaStream_t`` and return the ``cudaError_t`` of
the launch. It is compiled once per content hash into
``build/<name>-<hash>/lib<name>.so`` beside this file (a directory that
``.gitignore`` lists), for ``sm_90a``. No PyTorch headers are included, so
a build takes seconds, and ``ninja`` is not needed.

``build_all()`` starts one ``nvcc`` per source at once and waits for all;
``library(name)`` builds on first use, caches the loaded library and types
its launchers for ctypes once, from ``SIGNATURES`` (``bind``), so that a
call passes its arguments as they are. Where there is no ``nvcc`` (no CUDA
toolkit), asking for a kernel raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Dict, List

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "build")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-O3", "-std=c++17", "--shared", "-Xcompiler", "-fPIC",
              "-lineinfo", "-Xptxas", "-v"]

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# The forwards' shared signature: q, k, v, bias, gate, kv_len, out, lse,
# seed, B, H, T, D, scale, drop_thr, drop_scale, dtype, stream
_FWD = [_P] * 9 + [_I] * 4 + [_F, _I, _F, _I, _P]
# The argument types of each source's launchers (each returns a
# cudaError_t as an int): pointers and the stream as c_void_p, so that
# ctypes does not cut them to 32 bits.
SIGNATURES: Dict[str, Dict[str, list]] = {
    "flash_attention": {
        "wfl_flash_attention_fwd": _FWD,
        "wfl_flash_attention_bwd": [_P] * 15 + [_I] * 4 + [_F, _I, _F, _I,
                                                          _P]},
    "attention_fwd_mma": {"wfl_attention_fwd_mma": _FWD},
    "attention_fwd_bias_mma": {"wfl_attention_fwd_bias_mma": _FWD},
    "attention_bwd_mma": {
        "wfl_attention_bwd_mma": [_P] * 12 + [_I] * 5 + [_F, _I, _F, _I,
                                                         _P]},
    "attention_bwd_bias_mma": {
        "wfl_attention_bwd_bias_mma": [_P] * 16 + [_I] * 5 + [_F, _I, _F,
                                                              _I, _P],
        "wfl_attention_bwd_dq_mma": [_P] * 4 + [_I] * 5 + [_F, _I, _P],
        "wfl_attention_bias_dbias": [_P] * 6 + [_I] * 5 + [_P]},
    "attention_wide": {
        "wfl_attention_wide_fwd": _FWD,
        "wfl_attention_wide_bwd": [_P] * 14 + [_I] * 5 + [_F, _I, _F, _I,
                                                          _P]},
    "attention_wgmma": {
        # q, k, v, kv_len, out, lse, seed, B, H, T, d, width, scale,
        # drop_thr, drop_scale, stream
        "wfl_attention_wgmma_fwd": [_P] * 7 + [_I] * 5 + [_F, _I, _F, _P],
        # out, dout, lse, ws, B, H, T, d, stream
        "wfl_attention_wgmma_delta": [_P] * 4 + [_I] * 4 + [_P],
        # q, k, v, dout, ws, kv_len, seed, dk, dv, ds, B, H, T, d, width,
        # ldk, scale, drop_thr, drop_scale, stream
        "wfl_attention_wgmma_dkdv": [_P] * 10 + [_I] * 6 + [_F, _I, _F,
                                                            _P]},
}


class KernelBuildError(RuntimeError):
    """A CUDA kernel could not be built, loaded or launched."""


def nvcc_path() -> str:
    """The ``nvcc`` of the CUDA toolkit PyTorch found (``CUDA_HOME``)."""
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise KernelBuildError(
            "no CUDA toolkit found (torch.utils.cpp_extension.CUDA_HOME is "
            "None): the hand-written kernels cannot be built here")
    nvcc = os.path.join(CUDA_HOME, "bin", "nvcc")
    if not os.path.exists(nvcc):
        raise KernelBuildError(f"nvcc not found at {nvcc}")
    return nvcc


def _sources(name: str) -> List[str]:
    headers = sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC)
                     if f.endswith(".cuh"))
    return [os.path.join(CSRC, f"{name}.cu")] + headers


def _target(name: str) -> str:
    h = hashlib.sha256()
    for path in _sources(name):
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}",
                        f"lib{name}.so")


def _start(name: str):
    """Start nvcc for one source; returns (target, Popen) or (target, None)
    when the library is already built."""
    target = _target(name)
    if os.path.exists(target):
        return target, None
    os.makedirs(os.path.dirname(target), exist_ok=True)
    tmp = f"{target}.{os.getpid()}.tmp"
    cmd = [nvcc_path(), *ARCH_FLAGS, *NVCC_FLAGS, "-o", tmp,
           os.path.join(CSRC, f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    proc.wfl_tmp = tmp
    return target, proc


def _finish(name: str, target: str, proc) -> str:
    """Wait for one build; returns nvcc's output (register/smem report)."""
    if proc is None:
        return ""
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise KernelBuildError(f"nvcc failed for {name}.cu:\n{out}")
    os.replace(proc.wfl_tmp, target)
    return out


def build_all(names: List[str]) -> Dict[str, str]:
    """Build every named source in parallel (one nvcc each, all started
    together); returns nvcc's output per name. Loads each library."""
    started = {n: _start(n) for n in names}
    logs = {n: _finish(n, *started[n]) for n in names}
    for n in names:
        library(n)
    return logs


def bind(lib: ctypes.CDLL, name: str, only=None) -> ctypes.CDLL:
    """Type the launchers of ``lib``, a build of ``csrc/<name>.cu``, by
    ``SIGNATURES`` (and its ``wfl_error_string``); ``only``: these
    launchers alone (an earlier build that lacks the others). Returns
    ``lib``."""
    for fn_name, argtypes in SIGNATURES.get(name, {}).items():
        if only is not None and fn_name not in only:
            continue
        fn = getattr(lib, fn_name)
        fn.restype, fn.argtypes = ctypes.c_int, argtypes
    describe = lib.wfl_error_string
    describe.restype, describe.argtypes = ctypes.c_char_p, [ctypes.c_int]
    return lib


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``lib<name>.so``, built on first use, its
    launchers typed (``bind``)."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            target, proc = _start(name)
            _finish(name, target, proc)
            lib = bind(ctypes.CDLL(target), name)
            _LIBS[name] = lib
        return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launcher."""
    if err != 0:
        describe = lib.wfl_error_string
        raise KernelBuildError(
            f"{what}: launch failed with CUDA error {err} "
            f"({describe(err).decode()})")


def stream_ptr(device) -> int:
    import torch
    return torch.cuda.current_stream(device).cuda_stream
