"""The cases of the port's sharded-path tests (`test_torch_moe_distributed.py`,
`test_torch_dist_gnn.py`, `test_torch_grad_compression.py`,
`test_torch_lm_mesh.py`, `test_torch_checkpoint_mesh.py`,
`test_torch_lm_decode_mesh.py`, `test_torch_din_mesh.py`), shared by the
reference runner (`_sharded_ref.py`, JAX on 4 host devices) and the port's
workers (`_torch_sharded.py`, 4 gloo ranks): numpy and plain values only.

Parameters are drawn here with numpy, leaf by leaf from a seed and the
leaf's path, so both sides start from the same values without waiting on
each other: a test file starts the reference (`start_reference`) and runs
the port's ranks while it computes.
"""

from __future__ import annotations

import os
import subprocess
import sys
import zlib
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
REF_TIMEOUT_S = 300

WORLD = 4
AXES = ("data", "model")

# --- expert-parallel MoE: tests/test_moe_distributed.py's config ---------
MOE = dict(d_model=16, n_experts=6, n_experts_padded=8, top_k=2, d_ff_expert=32,
           d_ff_shared=24, capacity_factor=8.0)
MOE_SHAPES = {
    "router": (16, 6), "w_gate": (8, 16, 32), "w_up": (8, 16, 32), "w_down": (8, 32, 16),
    "shared/w_gate": (16, 24), "shared/w_up": (16, 24), "shared/w_down": (24, 16),
}
AUX_WEIGHT = 0.3  # loss = sum(out * W) + AUX_WEIGHT * aux
# name -> (mesh (data, model), tokens T, capacity a data shard (None: the
# config's factor), capacity factor). T_loc k <= 64 is the weight-
# stationary regime: T 16 at both meshes; T 256 gathers the weights.
MOE_CASES = {
    "ws-2x2": ((2, 2), 16, 16, 8.0),
    "gather-2x2": ((2, 2), 256, 256, 8.0),
    "ws-1x4": ((1, 4), 16, 16, 8.0),
    "gather-1x4": ((1, 4), 256, 256, 8.0),
    "drops-ws-2x2": ((2, 2), 16, 2, 8.0),
    "drops-gather-2x2": ((2, 2), 256, 24, 8.0),
    "factor-1x4": ((1, 4), 256, None, 1.25),
}
DROP_FREE = ("ws-2x2", "gather-2x2", "ws-1x4", "gather-1x4", "factor-1x4")

# --- distributed GNN: tests/test_distributed.py's graph at a (2, 2) mesh --
GNN_ARCHS = ("egnn", "pna", "graphcast", "equiformer-v2")
GNN_GRAPH = dict(n=120, m=3, seed=0)
GNN_MESH = (2, 2)
# name -> (arch, edge_chunk, capacity_slack): roomy, and a budget of one
# request in four that drops some
GNN_CASES = {a: (a, 128, 256) for a in GNN_ARCHS}
GNN_CASES["pna-tight"] = ("pna", 128, 1)

# --- gradient compression over a "pod" axis of 4 ------------------------
GC_SHAPES = {"w": (8, 16), "b": (5,), "e": (3, 4, 6)}  # a rank's leaf
GC_STEPS = 2


# --- the LM step on a mesh: the smoke configs under LM_TRAIN_RULES ---------
# name -> (arch, mesh shape, mesh axes, the smoke config's fields changed).
# At (1, 4) the smoke configs' 2 kv heads are fewer than the model ranks:
# each rank reads the one kv head its q head needs, gathered over "model".
# 12 q heads over 6 kv heads at (1, 4) gives a rank 3 q heads from two
# groups of 2: neither divides the other, so its kv heads repeat.
POD = ("pod", "data", "model")
LM_CASES = {
    "qwen3-4b/2x2": ("qwen3-4b", (2, 2), AXES, {}),
    "qwen3-4b/1x4": ("qwen3-4b", (1, 4), AXES, {}),
    "qwen3-4b/pod2x1x2": ("qwen3-4b", (2, 1, 2), POD, {}),
    "qwen3-4b/2x2-chunked": ("qwen3-4b", (2, 2), AXES, {"xent_chunk": 8}),
    "qwen3-4b/1x4-12x6-heads": ("qwen3-4b", (1, 4), AXES, {"n_heads": 12, "n_kv_heads": 6}),
    # d_ff 130 does not split 4 ways: the FFN's leaves stay whole along
    # "model" and every model rank runs the FFN alike, with no psum
    "qwen3-4b/1x4-whole-ffn": ("qwen3-4b", (1, 4), AXES, {"d_ff": 130}),
    "gemma2-27b/2x2": ("gemma2-27b", (2, 2), AXES, {}),
    "gemma2-27b/1x4": ("gemma2-27b", (1, 4), AXES, {}),
    "gemma2-27b/pod2x1x2": ("gemma2-27b", (2, 1, 2), POD, {}),
    "qwen2.5-14b/2x2": ("qwen2.5-14b", (2, 2), AXES, {}),
    "qwen2.5-14b/1x4": ("qwen2.5-14b", (1, 4), AXES, {}),
    "qwen2.5-14b/pod2x1x2": ("qwen2.5-14b", (2, 1, 2), POD, {}),
    # T_loc k = 24 x 2 <= 64: the weight-stationary regime, which routes the
    # data shards' tokens together, as one device does
    "qwen2-moe-a2.7b/2x2": ("qwen2-moe-a2.7b", (2, 2), AXES, {}),
}
LM_BATCH, LM_SEQ = 2, 24
LM_STEPS = 2  # warmup 1: step 0's learning rate is 0, step 1's the base rate
LM_CKPT_CASE = "qwen3-4b/2x2"  # saved on (2, 2), restored on (1, 4) and one device
LM_REF_SHARDED_CASE = "qwen3-4b/2x2"  # against the reference's own sharded step


LM_REF_PROCS = 2  # the reference's unsharded steps, in this many processes


# --- the decode step on a mesh: the smoke configs under the decode rules --
# name -> (arch, mesh shape, mesh axes, rules: "decode" for LM_DECODE_RULES,
# "long" for LM_LONG_DECODE_RULES). A cache of DECODE_SMAX positions drawn
# at pos DECODE_POS, then DECODE_STEPS steps: the write crosses the block
# boundary at 24 (DECODE_SMAX / 2) and, at (1, 4), the one at 24 of blocks of
# 12. gemma2's window of 16 spans blocks, and its local layers mask every
# position of some.
DECODE_SMAX, DECODE_POS, DECODE_STEPS = 48, 22, 4
DECODE_BATCH = {"decode": 4, "long": 1}  # long_500k's batch is 1, whole on every rank
DECODE_CASES = {
    "qwen3-4b/2x2": ("qwen3-4b", (2, 2), AXES, "decode"),
    "qwen3-4b/1x4": ("qwen3-4b", (1, 4), AXES, "decode"),
    "qwen3-4b/pod2x1x2": ("qwen3-4b", (2, 1, 2), POD, "decode"),
    "gemma2-27b/1x4": ("gemma2-27b", (1, 4), AXES, "decode"),
    "qwen2.5-14b/2x2": ("qwen2.5-14b", (2, 2), AXES, "decode"),
    "qwen2-moe-a2.7b/2x2": ("qwen2-moe-a2.7b", (2, 2), AXES, "decode"),
    "gemma2-27b/long-2x2": ("gemma2-27b", (2, 2), AXES, "long"),
}
# against the reference's own sharded decode, jitted on (2, 2)
DECODE_REF_SHARDED = ("qwen3-4b/2x2", "gemma2-27b/long-2x2")


# --- DIN on a mesh: the smoke config under DIN_RULES ----------------------
# name -> (mesh shape, mesh axes, the smoke config's fields changed). The
# smoke widths all split 4 ways; "1x4-whole" has widths that do not (as
# 200 and 40 do not split 16 ways at full size): attn 80 splits, 42 stays
# whole, the main MLP's 30 stays whole and 12 splits.
DIN_CASES = {
    "2x2": ((2, 2), AXES, {}),
    "1x4": ((1, 4), AXES, {}),
    "4x1": ((4, 1), AXES, {}),
    "pod2x1x2": ((2, 1, 2), POD, {}),
    "1x4-whole": ((1, 4), AXES, {"attn_hidden": (80, 42), "mlp_hidden": (30, 12)}),
}
DIN_B = 16  # rows of the batch: 4, 8 or 16 a rank
# candidates of the retrieval batch: 64 split over ("data", "model") (over
# "model" where "data" is 1); 66 falls back to ("data",) where "data" is 2
DIN_CANDS = (64, 66)
DIN_REF_SHARDED = "2x2"  # against the reference's own sharded step and retrieval


def din_variant(name: str) -> str:
    """The unsharded DIN a case is held to: its changed fields."""
    over = DIN_CASES[name][2]
    return "din" + "".join(f",{k}={v}" for k, v in sorted(over.items()))


def din_params(shapes: dict) -> dict:
    """{leaf: array} of a DIN config's {leaf: shape}."""
    return draw_tree(shapes, 3)


def din_edge_ids(n: int) -> np.ndarray:
    """Ids at the edges of the blocks of n rows on 1, 2 and 4 model ranks:
    each block's first and last row."""
    return np.unique([i for k in (1, 2, 4) for b in range(k)
                      for i in (b * n // k, (b + 1) * n // k - 1)]).astype(np.int32)


def din_batches(seq_len: int, n_items: int, n_cats: int, d_profile: int):
    """(a batch of DIN_B rows with labels, {n: a retrieval batch of n
    candidates}): ids drawn over the tables, the blocks' edge ids among
    them, histories padded with -1 (and a category behind a padded item),
    one candidate item id -1 (its category read, its row zero)."""
    rng = np.random.default_rng(17)
    B, L = DIN_B, seq_len
    hist = rng.integers(0, n_items, (B, L)).astype(np.int32)
    cats = rng.integers(0, n_cats, (B, L)).astype(np.int32)
    edges_i, edges_c = din_edge_ids(n_items), din_edge_ids(n_cats)
    hist[0, :edges_i.size] = edges_i
    cats[1, :edges_c.size] = edges_c
    lens = rng.integers(L // 4, L + 1, B)
    lens[0] = L
    pad = np.arange(L)[None, :] >= lens[:, None]
    hist[pad] = -1
    cats[pad] = rng.integers(0, n_cats, int(pad.sum()))
    batch = {"hist_items": hist, "hist_cats": cats,
             "cand_item": rng.integers(0, n_items, B).astype(np.int32),
             "cand_cat": rng.integers(0, n_cats, B).astype(np.int32),
             "profile": rng.standard_normal((B, d_profile)).astype(np.float32),
             "label": rng.integers(0, 2, B).astype(np.int32)}
    batch["cand_item"][:4] = edges_i[-4:]
    batch["cand_cat"][:4] = edges_c[-4:]
    retrieval = {}
    for n in DIN_CANDS:
        r = np.random.default_rng([19, n])
        h = r.integers(0, n_items, (1, L)).astype(np.int32)
        h[0, -3:] = -1
        items = r.integers(0, n_items, n).astype(np.int32)
        items[:edges_i.size] = edges_i
        items[-1] = -1
        retrieval[n] = {"hist_items": h,
                        "hist_cats": r.integers(0, n_cats, (1, L)).astype(np.int32),
                        "profile": r.standard_normal((1, d_profile)).astype(np.float32),
                        "cand_items": items,
                        "cand_cats": r.integers(0, n_cats, n).astype(np.int32)}
    return batch, retrieval


def decode_variant(name: str) -> str:
    """The unsharded decode a case is held to: its arch and batch."""
    arch, _, _, rules = DECODE_CASES[name]
    return f"{arch},b{DECODE_BATCH[rules]}"


def decode_inputs(arch_cfg, rules: str):
    """(the cache's {"layers/L/k" | "layers/L/v": (B, Hkv, DECODE_SMAX, Dh)}
    float32, drawn at every position (those from DECODE_POS on are masked
    until a step writes them), the tokens of each step (DECODE_STEPS, B, 1)
    int32) of a config with fields n_layers, n_kv_heads, head_dim, vocab."""
    B = DECODE_BATCH[rules]
    rng = np.random.default_rng([13, B])
    shape = (B, arch_cfg.n_kv_heads, DECODE_SMAX, arch_cfg.head_dim)
    cache = {f"layers/{li}/{n}": rng.standard_normal(shape).astype(np.float32)
             for li in range(arch_cfg.n_layers) for n in ("k", "v")}
    tokens = rng.integers(0, arch_cfg.vocab, (DECODE_STEPS, B, 1)).astype(np.int32)
    return cache, tokens


def lm_variant(name: str) -> str:
    """The unsharded step a case is held to: its arch and changed fields
    (the mesh does not change it)."""
    arch, _, _, over = LM_CASES[name]
    return arch + "".join(f",{k}={v}" for k, v in sorted(over.items()))


def lm_variants() -> list:
    return sorted({lm_variant(n) for n in LM_CASES})


def lm_tokens(vocab: int):
    """(tokens, labels) (LM_BATCH, LM_SEQ) int32."""
    rng = np.random.default_rng(11)
    return (rng.integers(0, vocab, (LM_BATCH, LM_SEQ)).astype(np.int32),
            rng.integers(0, vocab, (LM_BATCH, LM_SEQ)).astype(np.int32))


def lm_params(specs_flat: dict) -> dict:
    """{path: leaf} of the reference's stacked tree, from its {path: shape}."""
    return draw_tree(specs_flat, 2)


def flatten_specs(tree, prefix: str = "") -> dict:
    """A tree of dicts and lists with spec tuples at its leaves -> {path: spec}."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = enumerate(tree)
    else:
        return {prefix[:-1]: tree}
    out = {}
    for k, v in items:
        out.update(flatten_specs(v, f"{prefix}{k}/"))
    return out


def gnn_needs_pos(arch: str) -> bool:
    return arch in ("egnn", "equiformer-v2")


def draw(path: str, shape, seed: int) -> np.ndarray:
    """One leaf, float32, from (seed, path): N(0, 1) / sqrt(fan-in) for a
    matrix (its second-last dim), N(0, 0.1) for a vector."""
    rng = np.random.default_rng([seed, zlib.crc32(path.encode())])
    scale = 1.0 / np.sqrt(shape[-2]) if len(shape) >= 2 else 0.1
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def flatten(tree, prefix: str = "") -> dict:
    """A tree of dicts and lists -> {"a/0/b": leaf}."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix[:-1]: tree}
    out = {}
    for k, v in items:
        out.update(flatten(v, f"{prefix}{k}/"))
    return out


def unflatten(flat: dict, like):
    """`flatten`'s inverse, shaped as the tree `like`."""
    def build(node, prefix):
        if isinstance(node, dict):
            return {k: build(v, f"{prefix}{k}/") for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [build(v, f"{prefix}{i}/") for i, v in enumerate(node)]
        return flat[prefix[:-1]]
    return build(like, "")


def draw_tree(shapes: dict, seed: int) -> dict:
    """{path: shape} -> {path: leaf}."""
    return {p: draw(p, s, seed) for p, s in shapes.items()}


def moe_inputs(case: str):
    """(params {path: leaf}, x (T, d), the loss weights W (T, d))."""
    _, T, _, _ = MOE_CASES[case]
    params = draw_tree(MOE_SHAPES, 1)
    rng = np.random.default_rng([0, T])
    x = rng.standard_normal((T, MOE["d_model"])).astype(np.float32)
    w = rng.standard_normal((T, MOE["d_model"])).astype(np.float32)
    return params, x, w


def gnn_graph_inputs(d_in: int, n_out: int, n: int):
    """tests/test_distributed.py's features, labels and positions."""
    rng = np.random.default_rng(0)
    feats = rng.standard_normal((n, d_in)).astype(np.float32)
    labels = rng.integers(0, n_out, n).astype(np.int32)
    pos = rng.standard_normal((n, 3)).astype(np.float32)
    return feats, labels, pos


def gc_grads(step: int) -> dict:
    """{leaf: (WORLD, *shape)}: each rank's gradients at `step`, at scales
    that differ by rank so that the mean scale is not any rank's."""
    rng = np.random.default_rng([5, step])
    return {k: (rng.standard_normal((WORLD,) + s) *
                (1.0 + np.arange(WORLD)).reshape((WORLD,) + (1,) * len(s))).astype(np.float32)
            for k, s in GC_SHAPES.items()}


def mesh_coords(rank: int, mesh, axes=AXES) -> dict:
    """{axis: coordinate} of a rank on a mesh of these axes, row-major."""
    out = {}
    for a, n in reversed(list(zip(axes, mesh))):
        out[a], rank = rank % n, rank // n
    return out


def block(x: np.ndarray, spec, rank: int, mesh, axes=AXES) -> np.ndarray:
    """Rank's block of x under a spec of axis names (None, an axis, or a
    tuple of axes flattened in its order) on a mesh of these axes (default
    (data, model))."""
    c, size = mesh_coords(rank, mesh, axes), dict(zip(axes, mesh))
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        names = (entry,) if isinstance(entry, str) else entry
        n, i = 1, 0
        for a in names:
            n, i = n * size[a], i * size[a] + c[a]
        step = x.shape[dim] // n
        x = np.take(x, np.arange(i * step, (i + 1) * step), axis=dim)
    return x


def start_reference(whats, out_dir):
    """Start `_sharded_ref.py` for each group in `whats`, one process each,
    on 4 host devices; returns a function that waits for them and returns
    {what: the .npz's arrays}, raising with the stderr of any that failed."""
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([str(HERE.parent / "src"), str(HERE)]))
    paths = {w: Path(out_dir) / f"{w.replace(':', '_')}.npz" for w in whats}
    procs = {w: subprocess.Popen([sys.executable, str(HERE / "_sharded_ref.py"), w, str(p)],
                                 env=env, cwd=HERE, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True)
             for w, p in paths.items()}

    def finish() -> dict:
        errors = []
        try:
            for w, proc in procs.items():
                _, err = proc.communicate(timeout=REF_TIMEOUT_S)
                if proc.returncode:
                    errors.append(f"{w}:\n{err[-3000:]}")
        finally:
            for proc in procs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        if errors:
            raise RuntimeError("\n".join(errors))
        out = {}
        for w, p in paths.items():
            with np.load(p) as z:
                out[w] = {k: z[k] for k in z.files}
        return out

    return finish
