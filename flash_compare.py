"""This tree's flash-attention kernel against another source of it, timed
on one GPU in turns.

    mkdir -p build/other
    git archive <rev> src/repro_torch/kernels/csrc/flash_attention.cu | tar -x -C build/other
    python3 flash_compare.py build/other/src/repro_torch/kernels/csrc/flash_attention.cu

Builds the port's kernels twice, as they are and with the other flash
source in place of this one (`kernels.build`, both builds together), then
at every bf16 shape of `chip_smoke.py`'s ATTN_SHAPES and at one prefill
launch of its Qwen3-4B phase (4 requests) times other, this, this, other
(median of CUDA events each), both launched through the wrapper's own
arguments (`flash_attention.fwd_args`), beside SDPA where it computes the
same function and the bound; one JSON line a shape, then the card's name
and power limit. The other source must export `flash_attention_fwd` with
the C signature `kernels/build.py` declares. Needs a CUDA device; imports
no JAX.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

import chip_smoke as cs

ROOT = Path(__file__).resolve().parent
PREFILL_LAUNCH = ("qwen3-4b prefill launch, 4 requests", 4, 32, 8, 4096, 4096, 128, True,
                  None, None, torch.bfloat16)


def load(other: Path) -> dict:
    """{"other": library, "this": library}: the port's sources with `other`
    as the flash source, and as they are."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels.build import CSRC, build, load_library

    csrc = ROOT / "build" / "compare" / "csrc"
    shutil.rmtree(csrc, ignore_errors=True)
    shutil.copytree(CSRC, csrc)
    shutil.copyfile(other, csrc / "flash_attention.cu")
    with ThreadPoolExecutor(2) as pool:
        list(pool.map(build, (csrc, CSRC)))
    return {"other": load_library(csrc), "this": load_library(CSRC)}


def run(lib, q, k, v, causal, window, cap):
    from repro_torch.kernels.build import launch
    from repro_torch.kernels.flash_attention import fwd_args

    o = torch.empty_like(q)
    launch("flash_compare", lib.flash_attention_fwd, q.device,
           *fwd_args(q, k, v, o, causal, window, cap, None))
    return o


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", type=Path, help="another flash_attention.cu to time against this tree's")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("flash_compare: no CUDA device", file=sys.stderr)
        return 1
    libs = load(args.other.resolve())
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    shapes = [s for s in cs.ATTN_SHAPES if s[-1] == torch.bfloat16] + [PREFILL_LAUNCH]
    for name, B, Hq, Hkv, Sq, Skv, D, causal, window, cap, dtype in shapes:
        q = torch.randn(B, Hq, Sq, D, generator=g, device=dev).to(dtype)
        k = torch.randn(B, Hkv, Skv, D, generator=g, device=dev).to(dtype)
        v = torch.randn(B, Hkv, Skv, D, generator=g, device=dev).to(dtype)
        reps = 10 if Sq * Skv >= 2**22 else 30
        ms = {"other": [], "this": []}
        for n in ("other", "this", "this", "other"):
            ms[n].append(cs.median_ms(lambda: run(libs[n], q, k, v, causal, window, cap), reps))
        sdpa = None
        if window is None and cap is None:
            sdpa = cs.median_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                q, k, v, is_causal=causal, enable_gqa=True), reps)
        bound, by, _ = cs.attn_bound_ms(B, Hq, Hkv, Sq, Skv, D, causal, window, dtype)
        print(json.dumps(dict(shape=name, B=B, Hq=Hq, Hkv=Hkv, Sq=Sq, Skv=Skv, D=D,
                              other_ms=ms["other"], this_ms=ms["this"], sdpa_ms=sdpa,
                              bound_ms=bound, bound_by=by,
                              speedup=float(np.mean(ms["other"]) / np.mean(ms["this"])))),
              flush=True)
        del q, k, v
    print(cs.nvidia_smi())
    return 0


if __name__ == "__main__":
    sys.exit(main())
