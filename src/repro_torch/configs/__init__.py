"""Configurations of the port, one module each: the reference's
`model_cfg()` (full width) and `smoke_cfg()` (CPU test size).

  - LMs, dense (`qwen3_4b`, `qwen2_5_14b`, `gemma2_27b`) and MoE
    (`qwen2_moe_a2_7b`: 60 experts padded to 64, top-4, a shared expert;
    `dbrx_132b`: 16 experts, top-4);
  - the GNN zoo (`pna`, `egnn`, `graphcast`, `equiformer_v2`; their
    `model_cfg(shape)` reads `base.GNN_SHAPES`) and DIN (`din`, with its
    `SHAPES`);
  - the paper's own system (`grouting`: `GServeConfig`s of the distributed
    serving step at 4,194,304 nodes, with its `SHAPES`).

The reference's `ArchDef` cells and dry-run builders are JAX mesh
machinery and are not ported.
"""
