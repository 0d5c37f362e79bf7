"""Architecture registry: ``--arch <id>`` resolution (the reference's
`configs/__init__.py`).

10 assigned architectures + the paper's own system (grouting). Every entry
exposes its full config (`model_cfg`), a reduced smoke config for CPU tests
(`smoke_cfg`), its shape cells and a dry-run builder (`configs/base.py`):

  - LMs, dense (`qwen3_4b`, `qwen2_5_14b`, `gemma2_27b`) and MoE
    (`qwen2_moe_a2_7b`: 60 experts padded to 64, top-4, a shared expert;
    `dbrx_132b`: 16 experts, top-4);
  - the GNN zoo (`pna`, `egnn`, `graphcast`, `equiformer_v2`; their
    `model_cfg(shape)` reads `base.GNN_SHAPES`) and DIN (`din`, with its
    `SHAPES`);
  - the paper's own system (`grouting`: `GServeConfig`s of the distributed
    serving step at 4,194,304 nodes, with its `SHAPES`).
"""

from __future__ import annotations

from repro_torch.configs.base import ArchDef, Cell, DryRunSpec

_MODULES = {
    "qwen2-moe-a2.7b": "repro_torch.configs.qwen2_moe_a2_7b",
    "dbrx-132b": "repro_torch.configs.dbrx_132b",
    "qwen2.5-14b": "repro_torch.configs.qwen2_5_14b",
    "qwen3-4b": "repro_torch.configs.qwen3_4b",
    "gemma2-27b": "repro_torch.configs.gemma2_27b",
    "egnn": "repro_torch.configs.egnn",
    "pna": "repro_torch.configs.pna",
    "equiformer-v2": "repro_torch.configs.equiformer_v2",
    "graphcast": "repro_torch.configs.graphcast",
    "din": "repro_torch.configs.din",
    "grouting": "repro_torch.configs.grouting",
}

ASSIGNED = [k for k in _MODULES if k != "grouting"]  # the 10 graded archs


def get_arch(name: str) -> ArchDef:
    import importlib

    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULES)}")
    return importlib.import_module(_MODULES[name]).ARCH


def all_cells(include_grouting: bool = True):
    """Yield (arch_name, Cell) for every registered cell."""
    names = list(_MODULES) if include_grouting else ASSIGNED
    for n in names:
        for c in get_arch(n).cells:
            yield n, c
