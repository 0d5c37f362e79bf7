"""The port stands alone and runs on the card unless told otherwise.

  - no module of `src/repro_torch` (nor `chip_smoke.py`,
    `flash_compare.py` and `embed_sensitivity.py` beside it) imports
    `jax` or anything of `repro`, by an AST scan and by importing every
    module in a fresh interpreter;
  - entry points asked for no device raise where CUDA is absent, and run
    on the CPU only when `device="cpu"` is passed;
  - a kernel wrapper given CPU tensors runs the plain version and counts
    no launch (the attention wrapper's case is in test_torch_flash_attention);
  - `use_kernel=False` never reaches a kernel wrapper.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_parity import t
from repro_torch.kernels import frontier as fr
from repro_torch.kernels import ops
from repro_torch.kernels.embedding_bag import embedding_bag
from repro_torch.kernels.segment_reduce import segment_sum, segment_sum_sorted
from repro_torch.kernels.build import LAUNCHES

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _port_files():
    return sorted(PORT.rglob("*.py")) + [
        ROOT / n for n in ("chip_smoke.py", "flash_compare.py", "embed_sensitivity.py")]


def _modules():
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(PORT.parent).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_reference_imports_in_source(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, f"{path}: imports {name}"


def test_importing_the_port_loads_neither_jax_nor_repro():
    mods = list(_modules())
    assert "repro_torch.serve.engine" in mods and "repro_torch.convert" in mods
    assert "repro_torch.models.transformer" in mods and "repro_torch.kernels.ops" in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        f"bad = sorted(k for k in sys.modules if k.split('.')[0] in {FORBIDDEN!r})\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=ROOT, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def _cpu_parts():
    from repro_torch.core.router import Router, RouterConfig
    from repro_torch.core.storage import build_storage
    from repro_torch.graph.csr import to_padded
    from repro_torch.graph.generators import community_graph

    g = community_graph(n=120, community_size=30, seed=0)
    tier = build_storage(to_padded(g), n_shards=2, device="cpu")
    router = Router(2, RouterConfig(scheme="hash"), device="cpu")
    return g, tier, router


def test_entry_points_need_cuda_unless_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("this checks the behaviour on a machine without CUDA")
    from repro_torch import resolve_device
    from repro_torch.core.cache import make_cache
    from repro_torch.core.dispatch import make_backlog
    from repro_torch.core.embedding import (
        EmbedConfig, build_graph_embedding, incremental_embed_node,
    )
    from repro_torch.core.landmarks import build_landmark_index, incremental_add_node
    from repro_torch.core.router import Router, RouterConfig
    from repro_torch.core.storage import build_storage
    from repro_torch.configs import qwen3_4b
    from repro_torch.graph.csr import to_padded
    from repro_torch.models.param import init_params
    from repro_torch.models.transformer import Transformer, lm_param_specs
    from repro_torch.serve.engine import EngineRunConfig, ServingEngine
    from repro_torch.launch.train import build_smoke_training
    from repro_torch.train import Trainer, TrainerConfig

    g, tier, router = _cpu_parts()
    li = build_landmark_index(g, 2, n_landmarks=4, device="cpu")
    emb = build_graph_embedding(li.dist_to_lm, li.landmarks, EmbedConfig(1, 2, 2),
                                device="cpu")
    lm_cfg = qwen3_4b.smoke_cfg()
    cfg = EngineRunConfig(n_processors=2)
    calls = [
        lambda: resolve_device(),
        lambda: resolve_device("cuda"),
        lambda: ServingEngine(tier, router, cfg),
        lambda: make_cache(4, 2, 3),
        lambda: make_backlog(4),
        lambda: build_storage(to_padded(g), n_shards=2),
        lambda: Router(2, RouterConfig(scheme="hash")),
        lambda: build_landmark_index(g, 2, n_landmarks=4),
        lambda: incremental_add_node(li, g, 3),
        lambda: build_graph_embedding(li.dist_to_lm, li.landmarks, EmbedConfig(1, 2, 2)),
        lambda: incremental_embed_node(emb, li.dist_to_lm[3]),
        lambda: Transformer(lm_cfg),
        lambda: init_params(lm_param_specs(lm_cfg)),
        lambda: Trainer(None, dict, dict, TrainerConfig()),
        lambda: build_smoke_training("qwen3-4b", 2, 8),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert resolve_device("cpu") == torch.device("cpu")
    assert ServingEngine(tier, router, cfg, device="cpu").device.type == "cpu"
    assert Transformer(lm_cfg, device="cpu").device.type == "cpu"
    assert Trainer(None, dict, dict, TrainerConfig(), device="cpu").device.type == "cpu"


def test_wrapper_on_cpu_tensors_runs_plain_version_without_counting():
    rng = np.random.default_rng(0)
    rows = t(rng.integers(-1, 40, (2, 3, 4)).astype(np.int32))
    deg = t(rng.integers(0, 5, (2, 3)).astype(np.int32))
    vis = torch.zeros((2, 40), dtype=torch.bool)
    before = dict(LAUNCHES)
    out = fr.frontier_expand_batched(rows, deg, vis.clone())
    words = fr.frontier_expand_packed(rows, deg, fr.pack_words(vis), 40)
    vals = t(rng.standard_normal((10, 3)).astype(np.float32))
    seg = t(rng.integers(-1, 5, 10).astype(np.int32))
    sums = segment_sum(vals, seg, 5)
    sorted_sums = segment_sum_sorted(vals, seg.sort().values, 5)
    bags = embedding_bag(vals, seg.view(2, 5), combine="mean")
    assert dict(LAUNCHES) == before
    assert out.any() and torch.equal(fr.pack_words(out), words)
    assert sums.any() and sorted_sums.any() and bags.any()


def test_use_kernel_false_never_reaches_a_wrapper(monkeypatch):
    """With use_kernel=False, `ops` and `aggregate` take the plain version
    on any device: the kernel wrappers they import are not called."""
    from repro_torch.models.gnn.message_passing import aggregate

    def refuse(*_, **__):
        raise AssertionError("a kernel wrapper was called with use_kernel=False")

    monkeypatch.setattr(ops, "_segsum_kernel", refuse)
    monkeypatch.setattr(ops, "_bag_kernel", refuse)
    rng = np.random.default_rng(1)
    vals = t(rng.standard_normal((12, 4)).astype(np.float32))
    seg = t(rng.integers(-1, 6, 12).astype(np.int32))
    before = dict(LAUNCHES)
    ops.segment_sum(vals, seg, 6, use_kernel=False)
    ops.segment_mean(vals, seg, 6, use_kernel=False)
    ops.embedding_bag(vals, seg.view(3, 4), vals[:, 0].reshape(3, 4).contiguous(),
                      use_kernel=False)
    aggregate(vals, seg, 6, kinds=("sum", "mean", "max", "min", "std"), use_kernel=False)
    assert dict(LAUNCHES) == before
    with pytest.raises(AssertionError, match="use_kernel=False"):
        ops.segment_sum(vals, seg, 6)  # "auto" does reach the wrapper
    with pytest.raises(ValueError, match="use_kernel"):
        ops.segment_sum(vals, seg, 6, use_kernel="pallas")
