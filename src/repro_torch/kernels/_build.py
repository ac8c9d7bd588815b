"""Build and load the port's CUDA kernels (``src/repro_torch/csrc/*.cu``).

The sources are compiled by ``nvcc`` for ``sm_90a`` (Hopper) into one
shared library with a plain C interface, loaded with ``ctypes``.  No
PyTorch header is included, so a build takes seconds, not minutes.

  * The build happens at first use (the first kernel launch in a
    process), never at import: the CPU tests import every module.
  * Each source compiles in its own ``nvcc`` process, all started
    together, and one more ``nvcc`` links the objects.
  * The library lands in ``build/repro_torch/<hash of the sources>/`` at
    the repo root, written under a temporary name and renamed, so
    processes that build at the same time never load a half-written file.
  * ``nvcc``'s output for each source, with ``ptxas -v``'s registers,
    shared memory and spills of each kernel, is kept beside the library
    as ``<source stem>.log``.
  * A failed build raises with nvcc's output.  There is no fallback: a
    kernel that does not build is an error, not a reason to run the plain
    PyTorch version.

Every C entry point takes pointers and the stream as ``void*``
(``ctypes.c_void_p``), sizes as ``int``, and returns
``cudaGetLastError()`` after the launch; ``check`` raises on non-zero.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Optional

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
DEFAULT_CUDA_HOME = "/usr/local/cuda"
LIB_NAME = "librepro_torch_kernels.so"

P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float

# C entry points and their argument types (pointers and streams as void*)
SIGNATURES: Dict[str, List] = {
    # q, k, v, out, lse, B, Sq, Sk, H, KVH, hd, q_offset, causal, window,
    # scale, dtype_code, stream
    "flash_fwd": [P, P, P, P, P, I, I, I, I, I, I, I, I, I, F, I, P],
    # hd, dtype_code -> dynamic shared memory of a forward CTA (bytes)
    "flash_fwd_smem": [I, I],
    # dkv (0: the dq kernel, 1: dk/dv), hd, dtype_code -> its bytes
    "flash_bwd_smem": [I, I, I],
    # x, w, a_pool, b_pool, scale, ids, workspace, counters, y, M, K, N, R,
    # P, dtype_code, stream
    "lora_indexed": [P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, P],
    # M, K, N, R -> floats of its workspace
    "lora_indexed_work": [I, I, I, I],
    # M, N -> its int32 counters
    "lora_indexed_counters": [I, I],
    # M, K, N -> CTAs of its grid
    "lora_indexed_ctas": [I, I, I],
    # q, k, v, cache_len, workspace, counters, out, B, S, H, KVH, hd,
    # window, scale, dtype_code, stream
    "decode_attention": [P, P, P, P, P, P, P, I, I, I, I, I, I, F, I, P],
    # q, k_pool, v_pool, page_table, cache_len, workspace, counters, out, B,
    # n_pages, ps, P_max, H, KVH, hd, window, scale, dtype_code, stream
    "decode_attention_paged": [P, P, P, P, P, P, P, P, I, I, I, I, I, I, I,
                               I, F, I, P],
    # B, cache capacity, H, hd -> floats of the workspace of either decode
    # kernel (their counters: B * KVH)
    "decode_attention_work": [I, I, I, I],
    # GQA group, hd, dtype_code -> dynamic shared memory of a CTA (bytes)
    "decode_attention_smem": [I, I, I],
    # -> cache positions per chunk (one CTA per chunk, kv head, sequence)
    "decode_attention_chunk": [],
    # q, k, v, dout, lse, delta, dq, dk, dv, B, Sq, Sk, H, KVH, hd,
    # q_offset, causal, window, scale, dtype_code, stream
    "flash_bwd": [P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, I, I, F, I,
                  P],
    # x, w, a, b, scale, xa, y, M, K, N, R, dtype_code, stream
    "lora_fused_fwd": [P, P, P, P, P, P, P, I, I, I, I, I, P],
    # x, w, a, b, scale, g, xa, gb, workspace, counters, dx, da, db, M, K,
    # N, R, dtype_code, stream
    "lora_fused_bwd": [P, P, P, P, P, P, P, P, P, P, P, P, P, I, I, I, I, I,
                       P],
    # the backward's dA/dB pass: M, K, N, R -> floats of its workspace;
    # K, N -> its int32 counters; M, K, N -> CTAs of its grid; rank tile
    # (16, 32, 64), dtype_code -> dynamic shared memory of a CTA (bytes)
    "lora_fused_dab_work": [I, I, I, I],
    "lora_fused_dab_counters": [I, I],
    "lora_fused_dab_ctas": [I, I, I],
    "lora_fused_dab_smem": [I, I],
    # M, N -> rows of a wide-pass CTA (64 or 128)
    "lora_fused_tile": [I, I],
    # rows of the CTA, W read k-major (1: forward) or n-major (0: dx),
    # dtype_code -> dynamic shared memory of a wide-pass CTA (bytes)
    "lora_fused_smem": [I, I, I],
    # rank tile (16, 32, 64), Y read k-major (1: the forward's xa = x @ A)
    # or n-major (0: the backward's gb = g @ B^T), dtype_code -> dynamic
    # shared memory of a thin-pass CTA (bytes)
    "lora_fused_xa_smem": [I, I, I],
    # x, y, G, M, d, dtype_code, stream
    "smashed_roundtrip": [P, P, I, I, I, I, P],
    # x, q, scale, G, M, d, dtype_code, stream
    "smashed_quantize": [P, P, P, I, I, I, I, P],
    # q, scale, x, G, M, d, dtype_code, stream
    "smashed_dequantize": [P, P, P, I, I, I, I, P],
    # -> CTAs per thread block cluster of quantize and the round trip;
    # G, d -> CTAs of their grid; G, M, d -> CTAs of the dequantize grid
    "smashed_quant_cluster": [],
    "smashed_quant_ctas": [I, I],
    "smashed_dequant_ctas": [I, I, I],
    # x, dt, a, bm, c, y, cum workspace, states workspace (the chunk
    # states, then the per-group C.B^T tiles), B, S, H, G, P, N, chunk,
    # dtype_code, stream
    "ssd_scan_fwd": [P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, I, P],
    # pass (0 chunk state, 1 C.B^T, 2 chunk scan), head-dim tile (16, 32,
    # 64), N, chunk, dtype_code -> dynamic shared memory of a CTA (bytes)
    "ssd_scan_smem": [I, I, I, I, I],
}

# entry points that return a size in elements (64-bit); every other one
# returns an int
SIZE_FNS = ("lora_indexed_work", "decode_attention_work",
            "lora_fused_dab_work")

# dtype codes shared with csrc/common.cuh
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def dtype_code(dtype) -> int:
    if dtype not in DTYPE_CODES:
        raise TypeError(f"kernels take float32 or bfloat16 tensors, got {dtype}")
    return DTYPE_CODES[dtype]


def sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256()
    for f in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def find_nvcc() -> str:
    """nvcc from PATH, else $CUDA_HOME/bin, else /usr/local/cuda/bin."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", DEFAULT_CUDA_HOME)
    for cand in (Path(home) / "bin" / "nvcc",
                 Path(DEFAULT_CUDA_HOME) / "bin" / "nvcc"):
        if cand.is_file():
            return str(cand)
    raise RuntimeError(
        "nvcc not found (searched PATH, $CUDA_HOME/bin and "
        f"{DEFAULT_CUDA_HOME}/bin): the repro_torch CUDA kernels cannot be "
        "built, and the port does not fall back to the plain versions on "
        "a CUDA tensor")


def _run_all(cmds: List[List[str]]) -> List[str]:
    """Run the commands concurrently; return their outputs, or raise with
    the output of any failure."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    errors, outs = [], []
    for cmd, proc in zip(cmds, procs):
        out, _ = proc.communicate()
        outs.append(out)
        if proc.returncode != 0:
            errors.append(f"$ {' '.join(cmd)}\n{out}")
    if errors:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(errors))
    return outs


def build(out_dir: Optional[Path] = None) -> Path:
    """Compile csrc/*.cu into the shared library; return its path.

    Reuses a library already built from the same sources."""
    out_dir = Path(out_dir) if out_dir else BUILD_ROOT / source_hash()
    lib = out_dir / LIB_NAME
    if lib.is_file():
        return lib
    nvcc = find_nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.{time.monotonic_ns()}"
    objs = []
    cmds = []
    for src in sources():
        obj = out_dir / f"{src.stem}.{tag}.o"
        objs.append(obj)
        cmds.append([nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src),
                     "-o", str(obj)])
    for src, out in zip(sources(), _run_all(cmds)):
        # ptxas -v: registers, shared memory and spills of every kernel
        (out_dir / f"{src.stem}.log").write_text(out)
    tmp = out_dir / f"{LIB_NAME}.{tag}"
    _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
               *map(str, objs)]])
    os.replace(tmp, lib)
    for obj in objs:
        obj.unlink()
    return lib


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """Build (if needed) and load the kernels; declare every signature."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_longlong if name in SIZE_FNS else ctypes.c_int
    lib.repro_error_string.argtypes = [I]
    lib.repro_error_string.restype = ctypes.c_char_p
    return lib


_COUNTERS: Dict[tuple, torch.Tensor] = {}


def counters(name: str, device: torch.device, n: int) -> torch.Tensor:
    """At least n int32 counters for the kernel `name` on `device`, zeroed
    once and kept for the process, like the library itself: each launch
    leaves the counters it uses at zero (the last CTA of a reduction
    resets its own), so successive calls share them without seeing each
    other.  Two launches of one kernel may not run at once (another
    stream) on the same counters."""
    key = (name, device)
    buf = _COUNTERS.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 2 * buf.numel() if buf is not None else 0),
                          dtype=torch.int32, device=device)
        _COUNTERS[key] = buf
    return buf


def check(err: int, name: str) -> None:
    if err != 0:
        text = library().repro_error_string(err).decode()
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {err} ({text})")
