"""Build and load the port's CUDA kernels.

The kernels are CUDA C++ with a plain C interface (`csrc/*.cu`). At first
use, `load_library()` compiles every source in `csrc/` with nvcc for
`sm_90a` (one nvcc per source, all started together) and links them into
one shared library under `build/kernels/` at the root of the checkout,
named by a hash of the sources (so an edited source rebuilds and an
unchanged one is reused), and loads it with ctypes. Importing this module
builds nothing and needs no nvcc: the CPU tests import it on machines
without a CUDA toolkit.

`LAUNCHES` counts kernel launches per wrapper name; `launch` is the one
place that launches, checks the launch's error and counts.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from collections import Counter
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

# kernel launches per wrapper; CPU (plain-version) calls do not count
LAUNCHES: Counter = Counter()


def _sources(csrc: Path) -> list[Path]:
    return sorted(csrc.glob("*.cu"))


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                           "CUDA toolkit (set CUDA_HOME or put nvcc on PATH)")
    return found


def library_path(csrc: Path = CSRC) -> Path:
    """Where the library for the sources in `csrc` lives (built or not)."""
    h = hashlib.sha256()
    for src in _sources(csrc):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libkernels-{h.hexdigest()[:16]}.so"


def _run_all(cmds: list[list[str]]) -> None:
    """Run the commands in parallel; raise with the stderr of any that fails."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for c in cmds]
    failed = []
    for cmd, proc in zip(cmds, procs):
        _, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({' '.join(cmd)}):\n{err}")
    if failed:
        raise RuntimeError("\n".join(failed))


def build(csrc: Path = CSRC) -> Path:
    """Compile the sources in `csrc` (by default the port's) unless a
    library for them already exists."""
    out = library_path(csrc)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    # objects and library under private names, then a rename: concurrent
    # builders never see a half-written library
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [str(Path(tmp) / f"{src.stem}.o") for src in _sources(csrc)]
        _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)]
                  for obj, src in zip(objs, _sources(csrc))])
        lib = str(Path(tmp) / "lib.so")
        _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", lib, *objs]])
        os.replace(lib, out)
    return out


_P, _I32, _I64, _F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
SIGNATURES = {  # C entry point -> its argument types; each returns an int
    "frontier_expand_dense": [_P, _P, _P, _I64, _I64, _I32, _I64, _P],
    "frontier_expand_packed": [_P, _P, _P, _I64, _I64, _I32, _I64, _I64, _P],
    "flash_attention_fwd": [_P, _P, _P, _P, _I32, _I64, _I64, _I64, _I64, _I64,
                            _I32, _I32, _I32, _I64, _F32, _F32, _P],
    "flash_attention_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I32, _I64, _I64, _I64,
                            _I64, _I64, _I32, _I32, _I32, _I64, _F32, _F32, _P],
    "segment_sum": [_P, _P, _P, _P, _I64, _I64, _P, _P, _P, _I32, _I64, _I32, _P],
    "embedding_bag": [_P, _P, _P, _P, _I32, _I64, _I64, _I32, _I32, _I32, _P],
}


@functools.lru_cache(maxsize=None)
def load_library(csrc: Path = CSRC) -> ctypes.CDLL:
    """Build (first use only) and load the kernels; argtypes declared.
    `flash_compare.py` passes another `csrc` to load an older kernel."""
    lib = ctypes.CDLL(str(build(csrc)))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, _I32
    return lib


def launch(name: str, fn, device: torch.device, *args) -> None:
    """Call the C entry point `fn(*args, stream)` on `device`'s current
    stream; raise if the launch failed, else count it under `name`."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
    LAUNCHES[name] += 1
