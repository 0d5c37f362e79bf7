"""LM configurations of the port, one module each: the reference's
`model_cfg()` (full width) and `smoke_cfg()` (CPU test size) for the dense
LMs (`qwen3_4b`, `qwen2_5_14b`, `gemma2_27b`) and the MoE LMs
(`qwen2_moe_a2_7b`: 60 experts padded to 64, top-4, a shared expert;
`dbrx_132b`: 16 experts, top-4). The reference's `ArchDef` cells and
dry-run builders are JAX mesh machinery and are not ported.
"""
