"""How far bf16 teacher-forced decode is from prefill, in the reference
itself and in the port, for qwen2-moe-a2.7b at full width cut in depth,
on the CPU.

Decode's attention scores are an einsum of bf16 q and k whose result is
bf16 (`src/repro/models/transformer.py`, the decode branch of
`_attention`); prefill's are float32. Without qk_norm the init's scores
reach hundreds, where a bf16 step is about 0.3-1 of a score, and the
attention is nearly one-hot, so decode and prefill part already in bf16.
On the TPU the reference's prefill runs its Pallas flash kernel, whose
scores are float32; on the CPU it runs the plain version, whose scores
are bf16 like decode's. This script measures both in both packages, on the
same weights and tokens: the reference's decode against its own prefill
on the CPU's path and, at 1 layer, against its prefill through the flash
kernel in interpret mode (the TPU's path; at 1 layer the decode's cache
does not depend on the attention); the port's decode against its own
prefill on the CPU (the plain version; on the card the prefill runs the
flash kernel, with float32 scores); and all of it again with the same
weights upcast to float32.

Weights: the reference's `init_params` from `PRNGKey(0)`, each stacked
leaf drawn at the full depth's scale as `chip_smoke.draw_lm` draws a cut
model; tokens: `token_batch(0, B, S)`; drop-free (capacity factor E / k).

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/_moe_bf16_witness.py \
        [--layers 1] [--batch 1] [--prompt 1024]

About 10 GB of host memory at 1 layer; minutes, most of them in the
expert products.
"""

import argparse
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_arch
from repro.data.tokens import token_batch
from repro.kernels import ops
from repro.models import transformer as JT
from repro.models.param import ParamSpec
from repro.models.param import init_params as jinit_params
from repro_torch import convert
from repro_torch.models.transformer import Transformer


def rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def ref_flash_prefill(params, tokens, cfg):
    """The reference's prefill with its attention through its Pallas flash
    kernel (interpret mode), as it runs on the TPU: scores in float32."""
    pick = ops._pick
    ops._pick = lambda use_pallas: True
    try:
        full, _ = JT.prefill_forward(params, tokens, cfg)
    finally:
        ops._pick = pick
    return np.asarray(full, np.float32)


def ref_teacher_forced(params, tokens, cfg):
    """The reference: (last logits of the prefill of all S tokens, logits of
    decoding token S - 1 after a prefill of S - 1), on the CPU's path (the
    plain attention)."""
    B, S = tokens.shape
    full, _ = JT.prefill_forward(params, tokens, cfg)
    _, kvs = JT.prefill_forward(params, tokens[:, :-1], cfg)
    cache = JT.init_kv_cache(cfg, B, max_seq=S + 1)
    G = len(cfg.pattern)
    for li, c in enumerate(cache["layers"]):
        for n in ("k", "v"):
            c[n] = c[n].at[:, :, :S - 1].set(kvs[str(li % G)][n][li // G])
        c["pos"] = jnp.asarray(S - 1, jnp.int32)
    step, _ = JT.serve_step(params, cache, tokens[:, -1:], cfg)
    return np.asarray(full, np.float32), np.asarray(step, np.float32)


@torch.no_grad()
def port_teacher_forced(model, tokens):
    """The port: as `ref_teacher_forced`."""
    B, S = tokens.shape
    full, _ = model.prefill_forward(tokens)
    _, kvs = model.prefill_forward(tokens[:, :-1])
    cache = model.init_kv_cache(B, S + 1)
    G = model.cfg.group_size
    for li, c in enumerate(cache["layers"]):
        for n in ("k", "v"):
            c[n][:, :, :S - 1] = kvs[str(li % G)][n][li // G]
        c["pos"] = S - 1
    step, _ = model.serve_step(cache, tokens[:, -1:])
    return full.float().numpy(), step.float().numpy()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=1)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--prompt", type=int, default=1024)
    a = ap.parse_args()

    full = get_arch("qwen2-moe-a2.7b").model_cfg()
    cfg = dataclasses.replace(full, n_layers=a.layers,
                              capacity_factor=full.n_experts / full.top_k)
    scale = float(1.0 / np.sqrt(full.n_layers // len(full.pattern)))
    specs = jax.tree.map(
        lambda p: dataclasses.replace(p, scale=scale)
        if p.axes[0] == "stack" and p.init == "normal" and p.scale is None else p,
        JT.lm_param_specs(cfg), is_leaf=lambda x: isinstance(x, ParamSpec))
    params = jinit_params(specs, jax.random.PRNGKey(0))
    toks = token_batch(0, a.batch, a.prompt, cfg.vocab)["tokens"]
    out = dict(config=cfg.name, layers=a.layers, batch=a.batch, prompt=a.prompt)
    for dtype in ("bfloat16", "float32"):
        c = dataclasses.replace(cfg, dtype=getattr(jnp, dtype))
        p = jax.tree.map(lambda x: x.astype(jnp.float32), params) \
            if dtype == "float32" else params
        r_full, r_step = ref_teacher_forced(p, jnp.asarray(toks), c)
        r_flash = ref_flash_prefill(p, jnp.asarray(toks), c) if a.layers == 1 else None
        tcfg = convert.lm_config_from_reference(c)
        model = Transformer(tcfg, convert.lm_params_from_reference(p, tcfg, "cpu"),
                            device="cpu")
        t_full, t_step = port_teacher_forced(model, torch.from_numpy(toks))
        del model
        out[dtype] = dict(
            reference_decode_vs_prefill=rel_l2(r_step, r_full),
            reference_decode_vs_flash_prefill=None if r_flash is None else
            rel_l2(r_step, r_flash),
            reference_flash_vs_plain_prefill=None if r_flash is None else
            rel_l2(r_full, r_flash),
            port_decode_vs_prefill=rel_l2(t_step, t_full),
            port_vs_reference_prefill=rel_l2(t_full, r_full),
            port_vs_reference_decode=rel_l2(t_step, r_step),
            reference_same_argmax=float(np.mean(r_step.argmax(-1) == r_full.argmax(-1))))
        print(dtype, json.dumps(out[dtype]), flush=True)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
