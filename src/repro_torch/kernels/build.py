"""Build the hand-written CUDA kernels and load them with ``ctypes``.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for ``sm_90a`` into its own shared library under ``<repo>/build/kernels/``,
keyed by a hash of its source and the flags, at first use.  All missing
libraries are built at once, one ``nvcc`` process per source, in parallel.
Nothing is built when this module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import importlib.util
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("matmul", "flash_attention", "flash_attention_bwd")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"

# One H100 SM (compute capability 9.0) as the CUDA occupancy calculator
# counts it: registers are handed out per warp in units of 256, within each
# of 4 sub-partitions; shared memory in units of 128 bytes, with 1 KB the
# runtime keeps per block, out of 228 KB.
SM_REGISTERS = 65536
SM_SUBPARTITIONS = 4
SM_SMEM = 233472
BLOCK_RESERVED_SMEM = 1024
SM_WARPS = 64
SM_BLOCKS = 32

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           "build the hand-written kernels")
    return found


def library_path(name: str) -> Path:
    """Keyed by the source, the headers beside it and the flags."""
    src = b"".join(p.read_bytes() for p in
                   [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))])
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def log_path(name: str) -> Path:
    """The compiler's output kept beside the library it built."""
    return library_path(name).with_suffix(".log")


def build_all() -> Dict[str, str]:
    """Compile every kernel library that is not built yet, all in parallel.
    Returns ``{name: nvcc output}`` for every source (``-Xptxas -v``:
    registers, shared memory and spills per kernel); a library built
    earlier gives the output kept beside it.  Raises with the compiler's
    output if any build fails."""
    todo = [n for n in SOURCES
            if not (library_path(n).exists() and log_path(n).exists())]
    if todo:
        _compile(todo)
    return {n: log_path(n).read_text() for n in SOURCES}


def _compile(todo):
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    compiler = nvcc()
    procs = {}
    for name in todo:
        out = library_path(name)
        tmp = out.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [compiler, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(name)
            tmp.unlink(missing_ok=True)
        else:
            log_path(name).write_text(logs[name])
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))


def blocks_per_sm(threads: int, regs: int, smem: int) -> int:
    """Resident blocks of a kernel on one SM at ``threads`` a block,
    ``regs`` registers a thread and ``smem`` bytes of shared memory a
    block: the smallest of the warp, register, shared-memory and block
    limits (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``'s rule)."""
    up = lambda x, unit: -(-x // unit) * unit
    warps = up(threads, 32) // 32
    regs_warp = up(regs * 32, 256)
    if regs_warp * up(warps, SM_SUBPARTITIONS) > SM_REGISTERS:
        return 0
    by_regs = (SM_REGISTERS // SM_SUBPARTITIONS // regs_warp
               * SM_SUBPARTITIONS // warps) if regs_warp else SM_BLOCKS
    by_smem = SM_SMEM // up(smem + BLOCK_RESERVED_SMEM, 128)
    return min(SM_WARPS // warps, by_regs, by_smem, SM_BLOCKS)


def aligned16(t):
    """``t``, or a copy of it at a 16-byte aligned address: what the
    float32 kernels' 16-byte copies need of a dense operand."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def cuobjdump() -> str:
    """The toolkit's ``cuobjdump``, else the copy Triton's package carries
    (found without importing Triton)."""
    found = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(found):
        spec = importlib.util.find_spec("triton")
        if spec and spec.origin:
            found = str(Path(spec.origin).parent / "backends" / "nvidia"
                        / "bin" / "cuobjdump")
    if not os.path.exists(found):
        raise RuntimeError("cuobjdump not found: the CUDA toolkit or Triton "
                           "is needed to read the kernels' SASS")
    return found


def sass(name: str) -> Dict[str, str]:
    """``{mangled kernel name: its SASS}`` of the built library ``name``,
    from ``cuobjdump -sass``."""
    out = subprocess.run([cuobjdump(), "-sass", str(library_path(name))],
                         capture_output=True, text=True, check=True,
                         timeout=300).stdout
    parts = re.split(r"^\s*Function : (\S+)\s*$", out, flags=re.M)
    return dict(zip(parts[1::2], parts[2::2]))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel source ``name``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build_all()
            lib = ctypes.CDLL(str(library_path(name)))
            _libs[name] = lib
        return lib


def check(err: int, lib: ctypes.CDLL, what: str):
    """Raise if a launch returned a CUDA error (the C entry points return
    ``cudaGetLastError()`` right after the launch)."""
    if err != 0:
        describe = getattr(lib, f"pm2lat_{what}_error_string")
        describe.argtypes = [ctypes.c_int]
        describe.restype = ctypes.c_char_p
        msg = describe(err)
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err} "
                           f"({msg.decode() if msg else '?'})")
