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

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Iterator, List, Optional, Sequence

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
MAX_NODES = 32  # one warp per sample: lane n holds node n
BACKENDS = ("cuda", "torch")
# launches recorded into a CUDA graph, counted here instead of in
# ``CudaKernel.launches`` while a capture is being tallied
_TALLY: Optional[Dict["CudaKernel", int]] = None


def cuda_tool(name: str) -> str:
    """The path of a CUDA toolkit program (``nvcc``, ``cuobjdump``)."""
    for cand in (shutil.which(name), f"/usr/local/cuda/bin/{name}"):
        if cand and Path(cand).exists():
            return cand
    raise RuntimeError(f"{name} not found: the CUDA kernels build from "
                       f"source and need the CUDA toolkit")


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
    nvcc = cuda_tool("nvcc")
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


def c_function(name: str, symbol: str, argtypes: Sequence):
    """``symbol`` of library ``name`` (built at first use) as a ctypes
    function returning a CUDA error code, and the library's
    ``dfr_error_string``."""
    build([name])
    lib = ctypes.CDLL(str(library_path(name)))
    fn = getattr(lib, symbol)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    err = lib.dfr_error_string
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return fn, err


@contextlib.contextmanager
def tally_launches() -> Iterator[Dict["CudaKernel", int]]:
    """Count the launches made inside the block into the yielded dict, not
    into ``CudaKernel.launches``: a launch recorded into a CUDA graph during
    capture has not run.  The graph adds its tally at every replay
    (``runtime.graphs``)."""
    global _TALLY
    if _TALLY is not None:
        raise RuntimeError("launch tallies do not nest")
    _TALLY = {}
    try:
        yield _TALLY
    finally:
        _TALLY = None


class CudaKernel:
    """One kernel's C launcher in its shared library, plus its launch count.

    ``launches`` counts the kernel's runs: each successful eager launch
    here, and each replay of a CUDA graph that holds it, added by the graph
    (``runtime.graphs``); a launch recorded during capture counts in the
    capture's tally instead.  Nothing else increments it, so a run that
    resets it to 0 and reads it after sees exactly how often the kernel ran.
    """

    def __init__(self, name: str, symbol: str, argtypes: Sequence):
        self.name = name
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self._fn = None
        self._err = None

    def _function(self):
        if self._fn is None:
            self._fn, self._err = c_function(self.name, self.symbol,
                                             self.argtypes)
        return self._fn

    def launch(self, *args) -> None:
        """Launch on the current stream; raise on a CUDA error."""
        rc = self._function()(*args)
        if rc:
            raise RuntimeError(f"CUDA kernel '{self.name}' failed to launch: "
                               f"{self._err(rc).decode()} (error {rc})")
        if _TALLY is not None:
            _TALLY[self] = _TALLY.get(self, 0) + 1
        else:
            self.launches += 1


def check_operand(name: str, t, dtype, dev, shape=None) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor on ``dev`` (and,
    where given, of ``shape``)."""
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}, expected {dev}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must be {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_samples(j_seq, lengths, n_sys: int) -> tuple:
    """Validate the flat sample operands shared by K1, K2 and K5 (see
    ``kernels.ref``) for ``n_sys`` systems and return (N, T, Nx, samples
    per system, device)."""
    dev = j_seq.device
    if dev.type != "cuda":
        raise ValueError(f"CUDA kernel needs CUDA tensors, got {dev}")
    check_operand("j_seq", j_seq, torch.float32, dev)
    if j_seq.ndim != 3:
        raise ValueError(f"j_seq must be (N, T, Nx), got {tuple(j_seq.shape)}")
    n, t_len, nx = j_seq.shape
    if not (1 <= nx <= MAX_NODES):
        raise ValueError(f"the CUDA kernels take 1 <= Nx <= {MAX_NODES} "
                         f"(one warp per sample), got Nx={nx}")
    if n < 1 or t_len < 1:
        raise ValueError(f"empty j_seq {tuple(j_seq.shape)}")
    check_operand("lengths", lengths, torch.int32, dev, (n,))
    if n_sys < 1 or n % n_sys:
        raise ValueError(f"{n_sys} systems do not divide N={n} samples")
    return n, t_len, nx, n // n_sys, dev


def check_sample_operands(j_seq, lengths, p, q) -> tuple:
    """``check_samples`` plus the per-system gains p, q (S,) of K1 and K2."""
    if p.ndim != 1 or q.shape != p.shape:
        raise ValueError(f"p and q must be (S,), got {tuple(p.shape)} and "
                         f"{tuple(q.shape)}")
    out = check_samples(j_seq, lengths, p.shape[0])
    for name, t in (("p", p), ("q", q)):
        check_operand(name, t, torch.float32, out[-1])
    return out


def stream_handle(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def resolve_backend(backend: Optional[str], t) -> str:
    """The backend of one call (``kernels.ops``): 'cuda' for CUDA tensors
    and 'torch' for CPU tensors unless ``backend`` names one."""
    if backend is None:
        return "cuda" if t.is_cuda else "torch"
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected one of "
                         f"{BACKENDS} or None")
    if backend == "cuda" and not t.is_cuda:
        raise ValueError(f"backend='cuda' needs CUDA tensors, got a tensor "
                         f"on {t.device}")
    return backend
