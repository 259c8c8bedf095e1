"""Build, load and launch the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared library
with a plain C interface, loaded with ``ctypes`` (no PyTorch headers, so a
build takes seconds).  Libraries go to ``build/kernels/`` at the repository
root, keyed by a hash of the sources and flags, and are built at first use:
a fresh checkout builds them on its first kernel call.  Several missing
libraries build in parallel, one ``nvcc`` process per source.  A failed
build raises with the compiler's output.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, List, Sequence

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
MAX_NODES = 32  # one warp per sample: lane n holds node n


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and Path(cand).exists():
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build from source "
                       "and need the CUDA toolkit")


def _sources(name: str) -> List[Path]:
    return sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources(name):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str], verbose: bool = False) -> Dict[str, str]:
    """Compile every named library that is not built yet, all ``nvcc``
    processes started together.  Returns each new build's compiler output
    (with ``verbose``, ptxas's register and spill report)."""
    todo = [n for n in dict.fromkeys(names) if not library_path(n).exists()]
    if not todo:
        return {}
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name in todo:
        out = library_path(name)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, *(("-Xptxas", "-v") if verbose else ()),
               "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, tmp, out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, errors = {}, []
    for name, tmp, out, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            tmp.unlink(missing_ok=True)
            errors.append(f"{name}.cu: nvcc exited {proc.returncode}\n{log}")
        else:
            os.replace(tmp, out)  # atomic: concurrent builds agree
            logs[name] = log
    if errors:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(errors))
    return logs


class CudaKernel:
    """One kernel's C launcher in its shared library, plus its launch count.

    ``launches`` counts successful launches only, and only here: nothing
    else increments it, so a run that resets it to 0 and reads it after
    sees exactly how often the kernel ran.
    """

    def __init__(self, name: str, symbol: str, argtypes: Sequence):
        self.name = name
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self._lib = None
        self._fn = None
        self._err = None

    def _function(self):
        if self._fn is None:
            build([self.name])
            lib = ctypes.CDLL(str(library_path(self.name)))
            fn = getattr(lib, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            err = lib.dfr_error_string
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            self._lib, self._fn, self._err = lib, fn, err
        return self._fn

    def launch(self, *args) -> None:
        """Launch on the current stream; raise on a CUDA error."""
        rc = self._function()(*args)
        if rc:
            raise RuntimeError(f"CUDA kernel '{self.name}' failed to launch: "
                               f"{self._err(rc).decode()} (error {rc})")
        self.launches += 1


def check_sample_operands(j_seq, lengths, p, q) -> tuple:
    """Validate the flat operands shared by both kernels (see
    ``kernels.ref``) and return (N, T, Nx, samples per system, device)."""
    dev = j_seq.device
    if dev.type != "cuda":
        raise ValueError(f"CUDA kernel needs CUDA tensors, got {dev}")
    for name, t, dtype in (("j_seq", j_seq, torch.float32),
                           ("lengths", lengths, torch.int32),
                           ("p", p, torch.float32), ("q", q, torch.float32)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, j_seq on {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if j_seq.ndim != 3:
        raise ValueError(f"j_seq must be (N, T, Nx), got {tuple(j_seq.shape)}")
    n, t_len, nx = j_seq.shape
    if not (1 <= nx <= MAX_NODES):
        raise ValueError(f"the CUDA kernels take 1 <= Nx <= {MAX_NODES} "
                         f"(one warp per sample), got Nx={nx}")
    if n < 1 or t_len < 1:
        raise ValueError(f"empty j_seq {tuple(j_seq.shape)}")
    if lengths.shape != (n,):
        raise ValueError(f"lengths must be ({n},), got {tuple(lengths.shape)}")
    if p.ndim != 1 or q.shape != p.shape or p.shape[0] < 1 \
            or n % p.shape[0]:
        raise ValueError(f"p and q must be (S,) with S dividing N={n}, got "
                         f"{tuple(p.shape)} and {tuple(q.shape)}")
    return n, t_len, nx, n // p.shape[0], dev


def stream_handle(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
