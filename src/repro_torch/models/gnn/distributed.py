"""Distributed full-graph GNN training over the decoupled-storage substrate
(the reference's `models/gnn/distributed.py`).

The `ogb_products` cell (2.45M nodes, 61.9M edges, full batch) is message
passing over the flattened process mesh, with the paper's decoupled-storage
access pattern as the feature gather:

  node state   : striped over ranks (owner = id % D, slot = id // D), the
                 storage tier's placement;
  edges        : each edge lives on owner(dst), so the destination side of
                 every message is local; source features come through
                 `core.storage.sharded_feature_gather` (bucket by owner ->
                 all_to_all -> local gather -> all_to_all back);
  aggregation  : a segment reduce over the rank's own destination slots;
  edge chunking: edges stream through fixed-size chunks, so the gather
                 buffers and per-edge messages are O(chunk), not O(E / D).

Every rank calls the functions below at once, each on its own blocks
(`local_dist_inputs`). The parameters are replicated: they `enter` the
flattened group, and the loss's numerator and denominator are psum'd over
it (`distributed.collectives`), so the gradient on every rank is the
reference's data-parallel gradient. The gather is differentiable: a fetched
row's gradient goes back to its owner. The segment ops are the plain ones
(`kernels.ref`), as the reference reduces with `jax.ops.segment_*` here and
not with its Pallas kernel. A gather request over `gather_capacity` is
dropped and its edge contributes nothing, silently, as in the reference;
`gather_served` shows which.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.storage import bucket_by_owner, sharded_feature_gather, stripe_rows
from repro_torch.distributed import collectives as C
from repro_torch.kernels import ref
from repro_torch.models import layers as L
from repro_torch.models.gnn.equiformer_v2 import _rbf, coeff_layout
from repro_torch.models.gnn.message_passing import rows as gather_rows
from repro_torch.models.param import tree_map


@dataclasses.dataclass(frozen=True)
class DistGraphConfig:
    n_nodes: int
    n_devices: int  # flattened mesh size (== number of shards)
    rows_per_shard: int  # ceil(n_nodes / n_devices)
    edges_per_shard: int  # padded local edge count (multiple of edge_chunk)
    edge_chunk: int  # edges processed a chunk
    gather_capacity: int  # per-(rank, shard) request budget in one chunk
    d_feat: int
    n_out: int
    axes: Tuple[str, ...] = ("data", "model")  # flattened mesh axes

    @property
    def n_chunks(self) -> int:
        return self.edges_per_shard // self.edge_chunk


def plan_dist_graph(
    n_nodes: int,
    n_edges: int,
    mesh_shape: Dict[str, int],
    d_feat: int,
    n_out: int,
    edge_chunk: int = 32768,
    capacity_slack: int = 4,
    axes: Tuple[str, ...] = ("data", "model"),
) -> DistGraphConfig:
    """Static shapes for a (graph, mesh) pair."""
    D = int(np.prod([mesh_shape[a] for a in axes]))
    rows = -(-n_nodes // D)
    e_local = -(-n_edges // D)
    edge_chunk = min(edge_chunk, max(256, e_local))
    e_pad = -(-e_local // edge_chunk) * edge_chunk
    cap = max(8, capacity_slack * (-(-edge_chunk // D)))
    return DistGraphConfig(n_nodes=n_nodes, n_devices=D, rows_per_shard=rows,
                           edges_per_shard=e_pad, edge_chunk=edge_chunk, gather_capacity=cap,
                           d_feat=d_feat, n_out=n_out, axes=axes)


# ---------------------------------------------------------------------------
# host-side data layout
# ---------------------------------------------------------------------------


def prepare_dist_inputs(
    cfg: DistGraphConfig,
    src: np.ndarray,
    dst: np.ndarray,
    feats: np.ndarray,
    labels: np.ndarray,
    pos: Optional[np.ndarray] = None,
    seed: int = 0,
) -> dict:
    """Stripe node arrays and bucket edges by owner(dst) = dst % D, as numpy
    arrays bit for bit the reference's.

    Edges are shuffled before bucketing so that power-law hubs spread across
    chunks. Every output is a global array laid out shard-major: block r of
    dim 0 is rank r's (`local_dist_inputs`).
    """
    D = cfg.n_devices
    rng = np.random.default_rng(seed)
    perm = rng.permutation(src.size)
    src, dst = src[perm], dst[perm]
    owner = dst % D
    order = np.argsort(owner, kind="stable")
    src, dst, owner = src[order], dst[order], owner[order]

    e_src = np.full((D, cfg.edges_per_shard), -1, np.int32)
    e_dst = np.full((D, cfg.edges_per_shard), -1, np.int32)
    counts = np.bincount(owner, minlength=D)
    start = np.concatenate([[0], np.cumsum(counts)])
    for d in range(D):  # owner is sorted: shard d's edges are one run
        k = int(counts[d])
        if k > cfg.edges_per_shard:
            raise ValueError(f"device {d} owns {k} edges > padded capacity "
                             f"{cfg.edges_per_shard}; increase edge_chunk or rebalance")
        e_src[d, :k] = src[start[d]:start[d + 1]]
        e_dst[d, :k] = dst[start[d]:start[d + 1]]

    n_pad = cfg.rows_per_shard * D
    f = np.zeros((n_pad, feats.shape[1]), np.float32)
    f[: cfg.n_nodes] = feats
    lb = np.zeros((n_pad,), np.int32)
    lb[: cfg.n_nodes] = labels
    mask = np.zeros((n_pad,), np.float32)
    mask[: cfg.n_nodes] = 1.0
    out = {
        "feat": stripe_rows(f, D).astype(np.float32),
        "labels": stripe_rows(lb[:, None], D)[:, 0].astype(np.int32),
        "mask": stripe_rows(mask[:, None], D)[:, 0].astype(np.float32),
        "e_src": e_src.reshape(-1),
        "e_dst": e_dst.reshape(-1),
    }
    if pos is not None:
        p = np.zeros((n_pad, pos.shape[1]), np.float32)
        p[: cfg.n_nodes] = pos
        out["pos"] = stripe_rows(p, D).astype(np.float32)
    return out


def abstract_dist_inputs(cfg: DistGraphConfig, with_pos: bool) -> dict:
    """The global inputs' shapes and dtypes as `meta` tensors."""
    D = cfg.n_devices
    n_pad, e_pad = cfg.rows_per_shard * D, cfg.edges_per_shard * D
    meta = lambda shape, dtype: torch.empty(shape, dtype=dtype, device="meta")
    out = {
        "feat": meta((n_pad, cfg.d_feat), torch.float32),
        "labels": meta((n_pad,), torch.int32),
        "mask": meta((n_pad,), torch.float32),
        "e_src": meta((e_pad,), torch.int32),
        "e_dst": meta((e_pad,), torch.int32),
    }
    if with_pos:
        out["pos"] = meta((n_pad, 3), torch.float32)
    return out


def dist_input_pspecs(cfg: DistGraphConfig, with_pos: bool) -> dict:
    """Spec tuples (`distributed.mesh_utils`): dim 0 over the flattened axes."""
    ax = cfg.axes
    out = {"feat": (ax, None), "labels": (ax,), "mask": (ax,), "e_src": (ax,), "e_dst": (ax,)}
    if with_pos:
        out["pos"] = (ax, None)
    return out


def local_dist_inputs(inputs: dict, cfg: DistGraphConfig, mesh, device=None) -> dict:
    """This rank's blocks of `prepare_dist_inputs`' arrays (numpy, memory
    maps included, or tensors), as tensors on `device`: block
    `mesh.axis_index(cfg.axes)` of dim 0 (`dist_input_pspecs`, the
    shard_map in_specs' counterpart). Only the block is read."""
    n, i = mesh.axis_size(cfg.axes), mesh.axis_index(cfg.axes)
    out = {}
    for k in dist_input_pspecs(cfg, "pos" in inputs):
        v = inputs[k]
        size = v.shape[0] // n
        blk = v[i * size:(i + 1) * size]
        out[k] = (torch.from_numpy(np.array(blk)) if isinstance(blk, np.ndarray)
                  else blk.clone()).to(device)
    return out


# ---------------------------------------------------------------------------
# streaming edge pass
# ---------------------------------------------------------------------------


def _chunk_ids(cfg: DistGraphConfig, e_src: torch.Tensor, e_dst: torch.Tensor, ci: int):
    """(requested source ids (-1 where the edge is padding), dst ids, ok)."""
    s = e_src[ci * cfg.edge_chunk:(ci + 1) * cfg.edge_chunk]
    d = e_dst[ci * cfg.edge_chunk:(ci + 1) * cfg.edge_chunk]
    ok = (s >= 0) & (d >= 0)
    return torch.where(ok, s, -1), d, ok


def edge_stream(
    cfg: DistGraphConfig,
    payload: torch.Tensor,  # (rows_per_shard, F) local gatherable node state
    e_src: torch.Tensor,  # (edges_per_shard,) global src ids (-1 padded)
    e_dst: torch.Tensor,  # (edges_per_shard,) global dst ids (-1 padded)
    acc_init: Any,  # the accumulators
    chunk_fn: Callable,  # (acc, h_src, dst_slot, ok) -> acc
    group,
) -> Any:
    """Stream the rank's edges through fixed-size chunks; per chunk, gather
    the source rows from their owners over `group` (the flattened axes) and
    fold them into the accumulators. Every rank runs the same chunk count,
    so the collectives stay uniform."""
    D = cfg.n_devices
    acc = acc_init
    for ci in range(cfg.n_chunks):
        ids, d_ids, ok = _chunk_ids(cfg, e_src, e_dst, ci)
        h_src, served = sharded_feature_gather(ids, payload, group, D, cfg.gather_capacity)
        ok = ok & served  # dropped (over-capacity) requests contribute nothing
        dst_slot = torch.where(ok, torch.div(d_ids, D, rounding_mode="floor"), 0).long()
        acc = chunk_fn(acc, h_src, dst_slot, ok)
    return acc


def gather_served(cfg: DistGraphConfig, e_src: torch.Tensor, e_dst: torch.Tensor) -> torch.Tensor:
    """(n_chunks, edge_chunk) bool: the rank's edges whose source row
    `edge_stream` fetches, by the same bucketing `sharded_feature_gather`
    does (a rank's own computation, no collective). A real edge left out is
    a request over `gather_capacity`, dropped as the reference drops it."""
    D = cfg.n_devices
    out = []
    for ci in range(cfg.n_chunks):
        ids, _, ok = _chunk_ids(cfg, e_src, e_dst, ci)
        owners = torch.where(ids >= 0, ids % D, 0).to(torch.int32)
        _, slot = bucket_by_owner(ids, owners, D, cfg.gather_capacity)
        out.append(ok & (slot >= 0))
    return torch.stack(out)


def _seg_sum(x, slot, ok, rows):
    return ref.segment_sum_ref(torch.where(ok[:, None], x, 0.0), torch.where(ok, slot, rows), rows)


def _seg_max(x, slot, ok, rows):
    """jax.ops.segment_max's: -inf where a slot got nothing, the gradient
    split evenly among tied maxima."""
    slot = torch.where(ok, slot, rows)
    got = ref.segment_sum_ref(ok.float()[:, None], slot, rows) > 0
    return torch.where(got, ref.segment_max_ref(x, slot, rows), -torch.inf)


# ---------------------------------------------------------------------------
# per-architecture distributed forwards
# ---------------------------------------------------------------------------


def _mlp2(p, x, act=F.silu, final_act=False):
    x = act(x @ p["w1"] + p["b1"])
    x = x @ p["w2"] + p["b2"]
    return act(x) if final_act else x


def egnn_dist_forward(params, local, cfg: DistGraphConfig, model_cfg, group) -> torch.Tensor:
    """EGNN layers over the striped graph. local: this rank's blocks."""
    rows = cfg.rows_per_shard
    h = _mlp2(params["encoder"], local["feat"], final_act=True)
    x = local["pos"]

    for lp in params["layers"]:
        payload = torch.cat([h, x], -1)  # gatherable per-node state
        d = h.shape[1]

        def chunk_fn(acc, h_src, dst_slot, ok, lp=lp, d=d, payload=payload):
            hs, xs = h_src[:, :d], h_src[:, d:]
            pd = gather_rows(payload, dst_slot)
            ht, xt = pd[:, :d], pd[:, d:]
            diff = xt - xs
            dist2 = torch.sum(diff * diff, -1, keepdim=True)
            m = _mlp2(lp["phi_e"], torch.cat([ht, hs, dist2], -1), final_act=True)
            m = torch.where(ok[:, None], m, 0.0)
            w = _mlp2(lp["phi_x"], m)
            return {
                "m": acc["m"] + _seg_sum(m, dst_slot, ok, rows),
                "dx": acc["dx"] + _seg_sum(diff * w, dst_slot, ok, rows),
                "deg": acc["deg"] + _seg_sum(torch.ones_like(dist2), dst_slot, ok, rows),
            }

        z = lambda n: h.new_zeros((rows, n))
        acc = edge_stream(cfg, payload, local["e_src"], local["e_dst"],
                          {"m": z(d), "dx": z(3), "deg": z(1)}, chunk_fn, group)
        x = x + acc["dx"] / torch.clamp(acc["deg"], min=1.0)
        h = h + _mlp2(lp["phi_h"], torch.cat([h, acc["m"]], -1))
    return _mlp2(params["decoder"], h)


def pna_dist_forward(params, local, cfg: DistGraphConfig, model_cfg, group) -> torch.Tensor:
    """PNA over the striped graph.

    The moments are taken about a shift, each node's mean over the first
    chunk that holds one of its edges, fixed from then on: var = E[z^2] -
    E[z]^2 with z = m - shift. That is the reference's E[m^2] - E[m]^2
    exactly (the shift cancels from both views, so it carries no gradient),
    but a node whose messages sit close together no longer takes the
    difference of two large sums, whose float32 rounding the std view's
    backward scales by up to 1 / (2 sqrt(1e-6)) = 500."""
    rows = cfg.rows_per_shard
    h = F.relu(local["feat"] @ params["w_in"] + params["b_in"])
    delta = model_cfg.avg_log_degree

    # local degree (one edge pass over dst only: no gather)
    D = cfg.n_devices
    ok0 = local["e_dst"] >= 0
    slot0 = torch.where(ok0, torch.div(local["e_dst"], D, rounding_mode="floor"), rows)
    deg = ref.segment_sum_ref(ok0.float()[:, None], slot0, rows)[:, 0]
    logd = torch.log(deg + 1.0)
    # true divisions (a Python float divides by its reciprocal on CUDA)
    s_amp = L.div(logd, delta)[:, None]
    s_att = (torch.full_like(logd, delta) / torch.clamp(logd, min=1e-6))[:, None]

    for lp in params["layers"]:
        d = h.shape[1]

        def chunk_fn(acc, h_src, dst_slot, ok, lp=lp):
            ht = gather_rows(h, dst_slot)
            m = F.relu(torch.cat([ht, h_src], -1) @ lp["w_msg"] + lp["b_msg"])
            m = torch.where(ok[:, None], m, 0.0)
            cnt = _seg_sum(torch.ones_like(m[:, :1]), dst_slot, ok, rows)
            first = (acc["cnt"] == 0) & (cnt > 0)
            shift = torch.where(first, _seg_sum(m.detach(), dst_slot, ok, rows)
                                / torch.clamp(cnt, min=1.0), acc["shift"])
            z = m - gather_rows(shift, dst_slot)
            return {
                "shift": shift,
                "sum": acc["sum"] + _seg_sum(z, dst_slot, ok, rows),
                "sq": acc["sq"] + _seg_sum(z * z, dst_slot, ok, rows),
                "max": torch.maximum(acc["max"], _seg_max(m, dst_slot, ok, rows)),
                "min": torch.minimum(acc["min"], -_seg_max(-m, dst_slot, ok, rows)),
                "cnt": acc["cnt"] + cnt,
            }

        acc = edge_stream(
            cfg, h, local["e_src"], local["e_dst"],
            {"shift": h.new_zeros((rows, d)), "sum": h.new_zeros((rows, d)),
             "sq": h.new_zeros((rows, d)), "max": h.new_full((rows, d), -1e30),
             "min": h.new_full((rows, d), 1e30), "cnt": h.new_zeros((rows, 1))},
            chunk_fn, group)
        cnt = torch.clamp(acc["cnt"], min=1.0)
        mean_z = acc["sum"] / cnt
        mean = acc["shift"] + mean_z
        # maximum, not clamp: at a tie its gradient is half, as jnp.maximum's
        var = acc["sq"] / cnt - mean_z * mean_z
        std = torch.sqrt(torch.maximum(var, var.new_zeros(())) + 1e-6)
        has = acc["cnt"] > 0
        mx = torch.where(has, acc["max"], 0.0)
        mn = torch.where(has, acc["min"], 0.0)
        views = []
        for a in (mean, mx, mn, std):
            views.extend([a, a * s_amp, a * s_att])
        h = h + F.relu(torch.cat(views + [h], -1) @ lp["w_comb"] + lp["b_comb"])
    return h @ params["w_out"] + params["b_out"]


def graphcast_dist_forward(params, local, cfg: DistGraphConfig, model_cfg, group) -> torch.Tensor:
    """Generic-mode GraphCast (encode -> interaction layers -> decode).

    Edge state e is per edge and never moves (edges live with their dst);
    only source node features cross between ranks."""
    rows = cfg.rows_per_shard
    h = _mlp2(params["node_enc"], local["feat"])
    e_ok = (local["e_src"] >= 0) & (local["e_dst"] >= 0)
    e = _mlp2(params["edge_enc"], h.new_ones((local["e_src"].shape[0], 1)))
    e = torch.where(e_ok[:, None], e, 0.0)
    d = h.shape[1]

    for lp in params["processor"]:
        e_c = e.view(cfg.n_chunks, cfg.edge_chunk, d)

        def chunk_fn(acc, h_src, dst_slot, ok, lp=lp, e_c=e_c):
            agg, new_e = acc
            ht = gather_rows(h, dst_slot)
            e_blk = e_c[len(new_e)]
            e_new = _mlp2(lp["edge_mlp"], torch.cat([e_blk, h_src, ht], -1)) + e_blk
            e_new = torch.where(ok[:, None], e_new, 0.0)
            return agg + _seg_sum(e_new, dst_slot, ok, rows), new_e + [e_new]

        agg, new_e = edge_stream(cfg, h, local["e_src"], local["e_dst"],
                                 (h.new_zeros((rows, d)), []), chunk_fn, group)
        e = torch.cat(new_e)
        h = _mlp2(lp["node_mlp"], torch.cat([h, agg], -1)) + h
    return _mlp2(params["node_dec"], h)


def equiformer_dist_forward(params, local, cfg: DistGraphConfig, model_cfg,
                            group) -> torch.Tensor:
    """EquiformerV2 eSCN layers, streaming softmax attention.

    Per-head numerator and denominator are accumulated per destination row;
    the softmax shift is the global bound of the score (exact: a
    per-segment softmax is invariant to any constant shift)."""
    rows = cfg.rows_per_shard
    pairs, groups = coeff_layout(model_cfg.l_max, model_cfg.m_max)
    nc = len(pairs)
    C_ = model_cfg.d_hidden
    H = model_cfg.n_heads
    dev = local["feat"].device
    blocks = sorted(groups.items())
    order = torch.tensor([i for _, idxs in blocks for i in idxs], device=dev)
    unpermute = torch.argsort(order)
    block_idx = [torch.tensor(idxs, device=dev) for _, idxs in blocks]
    l_of = torch.tensor([l for l, _ in pairs], device=dev)

    h0 = F.silu(local["feat"] @ params["encoder_w"] + params["encoder_b"])
    x = torch.cat([h0[:, None, :], h0.new_zeros((rows, nc - 1, C_))], 1)
    pos = local["pos"]

    for lp in params["layers"]:
        payload = torch.cat([x.reshape(rows, nc * C_), pos], -1)

        def chunk_fn(acc, h_src, dst_slot, ok, lp=lp, x=x):
            msg = h_src[:, : nc * C_].reshape(-1, nc, C_)
            xs = h_src[:, nc * C_:]
            xt = gather_rows(pos, dst_slot)
            dist = torch.sqrt(torch.sum((xt - xs) ** 2, -1) + 1e-9)
            radial = F.silu(_rbf(dist, model_cfg.n_rbf) @ lp["rbf_w"])  # (E, n_groups)
            out = []
            for gi, ((m, _), idx) in enumerate(zip(blocks, block_idx)):
                blk = torch.einsum("ekc,kl->elc", torch.index_select(msg, 1, idx),
                                   lp["so2"][f"l_mix_{m}"])
                blk = blk @ lp["so2"][f"c_mix_{m}"]
                out.append(blk * radial[:, gi, None, None])
            out_msg = torch.index_select(torch.cat(out, 1), 1, unpermute)
            qi = gather_rows(x[:, 0, :], dst_slot) @ lp["attn_q"]  # (E, H)
            ki = out_msg[:, 0, :] @ lp["attn_k"]
            score = L.div(qi * ki, float(np.sqrt(C_)))
            score = 8.0 * torch.tanh(L.div(score, 8.0))  # bounded: a global shift is safe
            w = torch.where(ok[:, None], torch.exp(score - 8.0), 0.0)  # (E, H)
            flat = (out_msg.reshape(-1, nc * C_)[:, None, :] * w[:, :, None]).reshape(
                -1, H * nc * C_)
            return {"num": acc["num"] + _seg_sum(flat, dst_slot, ok, rows),
                    "den": acc["den"] + _seg_sum(w, dst_slot, ok, rows)}

        acc = edge_stream(cfg, payload, local["e_src"], local["e_dst"],
                          {"num": x.new_zeros((rows, H * nc * C_)), "den": x.new_zeros((rows, H))},
                          chunk_fn, group)
        den = torch.clamp(acc["den"], min=1e-9)  # (rows, H)
        aggv = L.div(torch.sum(acc["num"].reshape(rows, H, nc * C_) / den[:, :, None], 1),
                     float(H)).reshape(rows, nc, C_)
        gates = torch.sigmoid(aggv[:, 0, :] @ lp["gate_w"]).reshape(
            rows, model_cfg.l_max + 1, C_)
        x = x + (aggv * torch.index_select(gates, 1, l_of)) @ lp["out_mix"]
    return x[:, 0, :] @ params["decoder_w"] + params["decoder_b"]


DIST_FORWARDS = {
    "egnn": (egnn_dist_forward, True),  # (fn, needs_pos)
    "pna": (pna_dist_forward, False),
    "graphcast": (graphcast_dist_forward, False),
    "equiformer-v2": (equiformer_dist_forward, True),
}


# ---------------------------------------------------------------------------
# distributed loss
# ---------------------------------------------------------------------------


def make_dist_gnn_loss(arch: str, mesh, cfg: DistGraphConfig, model_cfg):
    """loss_fn(params, local) -> (loss, {"ce": loss}) for this rank's blocks
    `local` (`local_dist_inputs`) and the full, replicated parameters;
    every rank of the mesh calls it at once. Differentiable: the gradient
    on every rank is the reference's."""
    fwd, needs_pos = DIST_FORWARDS[arch]
    group = mesh.group(cfg.axes)

    def loss_fn(params, local):
        params = tree_map(lambda p: C.enter(p, group), params)
        out = fwd(params, local, cfg, model_cfg, group)  # (rows, n_out)
        lf = out.float()
        lse = torch.logsumexp(lf, -1)
        gold = lf.gather(1, local["labels"].long()[:, None])[:, 0]
        nll = (lse - gold) * local["mask"]
        num = C.psum(torch.sum(nll), group)
        den = C.psum(torch.sum(local["mask"]), group)
        loss = num / torch.clamp(den, min=1.0)
        return loss, {"ce": loss}

    return loss_fn
