"""LM configurations of the port, one module each (`qwen3_4b`,
`qwen2_5_14b`, `gemma2_27b`): the reference's `model_cfg()` (full width)
and `smoke_cfg()` (CPU test size) for the dense LMs. The reference's
`ArchDef` cells and dry-run builders are JAX mesh machinery and are not
ported.
"""
