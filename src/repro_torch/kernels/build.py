"""Build the port's CUDA kernels with nvcc and bind them with ctypes.

Every ``csrc/*.cu`` compiles to an object file, all with one ``nvcc``
each, started together; the objects link into one shared library under
``<repo>/build/kernels/``, named by a hash of the sources and flags, so a
checkout builds at first use and an edited source rebuilds.  The C entry
points take plain pointers and the stream, launch on that stream, and
return ``cudaGetLastError()``; :func:`launch` raises on a non-zero code
and counts the launch in :data:`LAUNCHES`.

Nothing here runs at import time: the CPU tests import every module.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                     "-Xptxas", "-v"]

_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
SIGNATURES = {
    # x, w, out, rows, d, eps, stream
    "rmsnorm_bf16": [_P, _P, _P, _I, _I, _F, _P],
    # q, k, v, out, lse, B, Sq, Skv, H, Hkv, D, causal, q_offset, scale, stream
    "flash_fwd_bf16": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                       _F, _P],
    # q, k_pages, v_pages, block_table, lengths, out, workspace,
    # B, H, Hkv, D, page, pages_per_slot, n_split, scale, stream
    "paged_decode_bf16": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                          _I, _I, _F, _P],
    # q, k_pages, v_pages, block_table, start, n_valid, out,
    # B, C, H, Hkv, D, page, pages_per_slot, scale, stream
    "paged_prefill_bf16": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                           _I, _I, _F, _P],
    # q, k, v, dout, lse, delta, dq,
    # B, Sq, Skv, H, Hkv, D, causal, q_offset, scale, stream
    "flash_bwd_dq_bf16": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                          _I, _I, _I, _F, _P],
    # q, k, v, dout, lse, delta, dk, dv,
    # B, Sq, Skv, H, Hkv, D, causal, q_offset, scale, stream
    "flash_bwd_dkv_bf16": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                           _I, _I, _I, _I, _F, _P],
    # q, k, v, out, workspace, B, S, H, Hkv, D, cache_len, n_split, scale,
    # stream
    "decode_attention_bf16": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                              _F, _P],
    # a, b, out, E, M, N, K, a strides (e, m, k), b strides (e, k, n), stream
    "moe_gemm_bf16": [_P, _P, _P, _I, _I, _I, _I, _L, _L, _L, _L, _L, _L,
                      _P],
    # x, codes, scales, rows, block, stream
    "quantize_int8_f32": [_P, _P, _P, _L, _I, _P],
    # codes, scales, out, rows, block, stream
    "dequantize_int8_f32": [_P, _P, _P, _L, _I, _P],
}

# launches per kernel; a wrapper adds one only where its kernel launched
LAUNCHES = {"rmsnorm": 0, "flash_fwd": 0, "paged_decode": 0,
            "paged_prefill": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
            "moe_gemm": 0, "decode_attention": 0, "quantize": 0,
            "dequantize": 0}

_lib = None
_lock = threading.Lock()


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.iterdir()):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"librepro_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile and link the kernels unless this source hash is built.

    The compiler's output (registers, shared memory and spills per
    kernel, from ``-Xptxas -v``) is kept beside the library as
    ``<name>.log``."""
    out = library_path()
    if out.exists():
        return out
    nvcc = _nvcc()
    tmp = BUILD_DIR / f"{out.stem}.tmp{os.getpid()}"
    tmp.mkdir(parents=True, exist_ok=True)
    try:
        jobs = []
        for src in sorted(CSRC.glob("*.cu")):
            obj = tmp / f"{src.stem}.o"
            jobs.append((src, obj, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs = []
        for src, _, proc in jobs:
            log = proc.communicate()[0]
            logs.append(f"== {src.name}\n{log}")
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src.name}:\n{log}")
        lib = tmp / out.name
        subprocess.run([nvcc, *ARCH, "-shared", *[str(o) for _, o, _ in jobs],
                        "-o", str(lib)], check=True)
        out.with_suffix(".log").write_text("\n".join(logs))
        os.replace(lib, out)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def _kernel_name(sym: str) -> str:
    """A mangled kernel name as its last name and integer template
    arguments: ``_ZN5repro4ffwd16flash_fwd_kernelILi128E...`` ->
    ``flash_fwd_kernel<128,...>``."""
    pos, names = 3 if sym.startswith("_ZN") else 2, []
    while pos < len(sym) and sym[pos].isdigit():
        n = re.match(r"\d+", sym[pos:]).group()
        pos += len(n)
        names.append(sym[pos:pos + int(n)])
        pos += int(n)
        if not sym.startswith("_ZN"):
            break
    args = re.findall(r"Li(-?\d+)E", sym[pos:])
    return f"{names[-1] if names else sym}" + (f"<{','.join(args)}>" if args
                                                 else "")


def ptxas_report(log: str, only: str = "") -> list:
    """One line a kernel from nvcc's ``-Xptxas -v`` output: its name
    (``_kernel_name``), registers, spilled bytes and ptxas's C75xx notes
    on wgmma (C7515 and C7511: every wgmma serialized; C7519: a fence of
    its own); ``only`` keeps the kernels whose name holds it."""
    kernels, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for)"
                      r" '?(_Z\w+)", ln)
        if m:
            name = _kernel_name(m.group(1))
            kernels.setdefault(name, [])
            continue
        notes = re.findall(r"\((C75\d\d)\)", ln)
        if notes:                   # it names its kernel, which may come later
            m = re.search(r"in function '(_Z\w+)'", ln)
            key = _kernel_name(m.group(1)) if m else name
            if key is not None:
                kernels.setdefault(key, []).extend(notes)
            continue
        m = re.search(r"Used (\d+) registers", ln) or \
            re.search(r"(\d+) bytes spill stores", ln)
        if m and name is not None:
            unit = "registers" if "Used" in ln else "B spilled"
            kernels[name].append(f"{m.group(1)} {unit}")
    return [f"{k}: {', '.join(v)}" for k, v in kernels.items()
            if only in k and v]


def lib() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            so = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(so, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            so.repro_cuda_error_string.argtypes = [ctypes.c_int]
            so.repro_cuda_error_string.restype = ctypes.c_char_p
            _lib = so
    return _lib


def refuse_autograd(name: str, *tensors) -> None:
    """Raise if a raw kernel wrapper would cut a gradient: the kernels
    launch through raw pointers and return tensors with no autograd
    history, so under grad mode an input that requires grad must go
    through the ``torch.autograd.Function`` of ``kernels/ops.py``."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: an input requires grad and the raw kernel wrapper "
            f"has no backward; call it through repro_torch.kernels.ops")


def check(t: torch.Tensor, name: str, dtype, shape=None) -> None:
    """Raise unless ``t`` is what a kernel takes: a contiguous CUDA
    tensor of ``dtype`` (and ``shape``), 16-byte aligned."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: data pointer not 16-byte aligned")


def launch(kernel: str, fn_name: str, device: torch.device, *args) -> None:
    """Call C entry point ``fn_name`` on the current stream of ``device``
    (appended as the last argument); raise on a CUDA error."""
    so = lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(so, fn_name)(*args, stream)
    if err != 0:
        msg = so.repro_cuda_error_string(err).decode()
        raise RuntimeError(f"{fn_name}: CUDA error {err} ({msg})")
    LAUNCHES[kernel] += 1
