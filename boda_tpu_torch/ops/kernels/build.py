"""Build and load the hand-written CUDA kernels (``boda_tpu_torch/csrc``).

Every ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` at first use,
one ``nvcc`` per source, all started together; the objects are linked into
one shared library with a plain C interface, loaded with ``ctypes``. The
library lands in ``build/kernels/`` at the repo root (git-ignored) under a
name carrying the hash of the sources and flags, so an edited source is
rebuilt and a stale library is never loaded. Nothing here touches CUDA or
spawns a process at import time: the CPU tests import every module.

Each C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`check` raises when that is not 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
# C signatures: every pointer and the stream are c_void_p (a bare Python int
# would be passed as a 32-bit int and cut the pointer)
_SIGS = {
    "boda_gemm": [_P] * 6 + [_I] * 11 + [_P],
    "boda_conv2d": [_P] * 6 + [_I] * 20 + [_P],
    "boda_atb": [_P, _P, _P, _P] + [_I] * 19 + [_P],
    "boda_pool2d": [_P, _P] + [_I] * 17 + [_P],
    "boda_bottleneck": [_P] * 8 + [_I] * 7 + [ctypes.POINTER(ctypes.c_int), _P],
    "boda_bottleneck_plan": [_I] * 8 + [ctypes.POINTER(ctypes.c_int)],
    "boda_eltwise": [_P, _P, _P, ctypes.c_longlong] + [_I] * 6 + [_P],
    "boda_stem": [_P] * 4 + [_I] * 14 + [_P],
}


# the source of each of boda_tpu's kernels that the port's entries launch
# (ops/kernels/common.py KernelCall.kernel)
KERNEL_SOURCES = {"K1": "sgemm.cu", "K2": "conv.cu", "K3": "conv.cu", "K4": "conv.cu",
                  "K5": "atb.cu", "K6": "block.cu", "K7": "stem.cu", "K8": "pool.cu",
                  "K9": "eltwise.cu"}


class KernelBuild:
    """The loaded library, plus how it was built (for the smoke report)."""

    def __init__(self, lib: ctypes.CDLL, path: Path, secs: float, log: str):
        self.lib = lib
        self.path = path
        self.build_secs = secs   # 0.0 when an up-to-date library was reused
        self.log = log           # nvcc's output (ptxas register/spill lines)


_loaded: KernelBuild | None = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH or $CUDA_HOME/bin): the CUDA "
                       "kernels are built on the machine with the card")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cu*")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def load() -> KernelBuild:
    """Build (if the sources changed) and load the kernel library once per
    process."""
    global _loaded
    if _loaded is not None:
        return _loaded
    so = BUILD_DIR / f"libboda_kernels_{source_hash()}.so"
    secs, log = 0.0, ""
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        nvcc = _nvcc()
        t0 = time.perf_counter()
        objs, procs = [], []
        for src in _sources():
            obj = BUILD_DIR / f"{src.stem}.{os.getpid()}.o"
            cmd = [nvcc, *NVCC_FLAGS, f"-I{CSRC}", "-c", "-o", str(obj), str(src)]
            objs.append(obj)
            procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.STDOUT, text=True)))
        failed = []
        for cmd, proc in procs:  # waits for every compile, failed or not
            out, _ = proc.communicate()
            log += out
            if proc.returncode != 0:
                failed.append(f"{' '.join(cmd)}\n{out}")
        if not failed:
            cmd = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]
            r = subprocess.run(cmd, capture_output=True, text=True)
            log += r.stdout + r.stderr
            if r.returncode != 0:
                failed.append(f"{' '.join(cmd)}\n{r.stdout}{r.stderr}")
        for obj in objs:
            obj.unlink(missing_ok=True)
        secs = time.perf_counter() - t0
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        os.replace(tmp, so)  # atomic: a concurrent loader never sees half a file
        (BUILD_DIR / (so.stem + ".log")).write_text(log)
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _SIGS.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    _loaded = KernelBuild(lib, so, secs, log)
    return _loaded


def write_ptx(sources: list[str], out_dir) -> list[str]:
    """``nvcc -ptx`` of the given ``csrc`` sources under the build's arch
    flags into ``out_dir`` (one nvcc per source, all started together);
    returns the files' names."""
    nvcc, procs, names = _nvcc(), [], []
    for src in sources:
        name = Path(src).with_suffix(".ptx").name
        cmd = [nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-ptx", f"-I{CSRC}",
               "-o", str(Path(out_dir) / name), str(CSRC / src)]
        procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True)))
        names.append(name)
    failed = []
    for cmd, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)}\n{out}")
    if failed:
        raise RuntimeError("nvcc -ptx failed:\n" + "\n".join(failed))
    return names


def check(rc: int, what: str) -> None:
    if rc != 0:
        import torch
        raise RuntimeError(f"{what}: CUDA launch failed with error {rc} "
                           f"({torch.cuda.get_device_name()})")


def stream_ptr(t) -> int:
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream
