"""Plain PyTorch versions of the port's CUDA kernels.

Each function computes exactly what its kernel computes, with ordinary
tensor ops, on any device. A kernel wrapper takes its plain version for
tensors that lie on the CPU (the tests), and `chip_smoke.py` holds each
kernel against its plain version on the card. The frontier versions are
also the `scatter` expansion backend of `core.visited`. The attention
versions are the reference's own, whose products run in the input dtype
where the kernel's run in float32 (so bf16 compares within 2e-2); they are
also `kernels.ops.attention`'s path wherever the kernel does not run
(decode offsets, one-row queries, CPU tensors). The segment and bag
versions sum in float32 (float64 for float64 inputs, which is how
`chip_smoke.py` gets its exact references), as their kernels do.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.frontier import pack_words

# What the segment and bag wrappers take on CPU tensors, where they run the
# plain versions below: their kernels' float32 and bfloat16, and float16,
# which the reference's jnp path computes too. float64 is refused: the
# reference runs with JAX's x64 off and never computes in it (the plain
# versions themselves take it, for `chip_smoke.py`'s exact references).
PLAIN_DTYPES = (torch.float32, torch.bfloat16, torch.float16)


def mark(idx: torch.Tensor, ok: torch.Tensor, size: int) -> torch.Tensor:
    """(size,) bool with True at idx[ok]. Every store writes the same value,
    and entries not ok go to a dump slot past the end, so the result does
    not depend on the order in which duplicate stores land."""
    slot = torch.where(ok, idx.long(), size).reshape(-1)
    out = torch.zeros(size + 1, dtype=torch.bool, device=idx.device)
    return out.index_fill_(0, slot, True)[:size]


def in_range(ids: torch.Tensor, n: int) -> torch.Tensor:
    """0 <= ids < n. The limit is compared as ids <= n - 1 clamped to the
    ids' dtype: a Python int past its range would wrap (n >= 2**31 for
    int32 ids), and then no id would be in range."""
    return (ids >= 0) & (ids <= min(n - 1, torch.iinfo(ids.dtype).max))


def _delta(rows: torch.Tensor, deg: torch.Tensor, n: int) -> torch.Tensor:
    """(B, n) bool: the candidates one hop marks (w < deg, 0 <= id < n)."""
    B, F, W = rows.shape
    width_ok = torch.arange(W, device=rows.device)[None, None, :] < deg[:, :, None]
    ok = width_ok & in_range(rows, n)
    flat = torch.arange(B, device=rows.device)[:, None, None] * n + rows
    return mark(flat, ok, B * n).view(B, n)


def frontier_expand_batched_ref(rows: torch.Tensor, deg: torch.Tensor,
                                visited: torch.Tensor) -> torch.Tensor:
    """visited[b] |= {rows[b,f,w] : w < deg[b,f], 0 <= id < n}, in place."""
    return visited.logical_or_(_delta(rows, deg, visited.shape[1]))


def frontier_expand_packed_ref(rows: torch.Tensor, deg: torch.Tensor,
                               words: torch.Tensor, n: int) -> torch.Tensor:
    """The same update on int32-held packed words (bit id%32 of word id//32),
    in place: the hop's delta is scattered densely, packed once, ORed in."""
    return words.bitwise_or_(pack_words(_delta(rows, deg, n)))


# ---------------------------------------------------------------------------
# attention (the reference's kernels/ref.py, the same ops in the same order)
# ---------------------------------------------------------------------------

MASK_VALUE = -1e30  # finite, as the reference's: fully masked rows average v


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True, window: Optional[int] = None,
                  softcap: Optional[float] = None, scale: Optional[float] = None,
                  q_offset: int = 0) -> torch.Tensor:
    """GQA attention, q (B, Hq, Sq, D), k/v (B, Hkv, Skv, D) -> (B, Hq, Sq, D).
    Products in the input dtype, logits and softmax in float32; query i sits
    at position q_offset + i, key j at j; a row with every key masked gets
    the mean of v."""
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    if Hq % Hkv:
        raise ValueError(f"GQA needs Hq % Hkv == 0, got {Hq} and {Hkv}")
    group = Hq // Hkv
    scale = scale if scale is not None else 1.0 / (D ** 0.5)
    kr = torch.repeat_interleave(k, group, dim=1)
    vr = torch.repeat_interleave(v, group, dim=1)
    logits = torch.einsum("bhqd,bhkd->bhqk", q, kr).float() * scale
    if softcap is not None:
        logits = softcap * torch.tanh(
            logits / torch.full((1,), softcap, dtype=logits.dtype, device=q.device))
    qpos = torch.arange(Sq, device=q.device)[:, None] + q_offset
    kpos = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    logits = torch.where(mask, logits, torch.full((), MASK_VALUE, device=q.device))
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p.to(q.dtype), vr)


def attention_grads_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        do: torch.Tensor, causal: bool = True, window: Optional[int] = None,
                        softcap: Optional[float] = None, scale: Optional[float] = None
                        ) -> tuple:
    """(dq, dk, dv) of `attention_ref` for the output gradient `do`, by
    autograd through it: the plain version of the flash backward kernel."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        out = attention_ref(*leaves, causal=causal, window=window, softcap=softcap,
                            scale=scale)
        return torch.autograd.grad(out, leaves, do)


ATTN_CHUNK = 512  # q rows a chunk of `attention_chunked_ref`


def attention_chunked_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True, window: Optional[int] = None,
                          softcap: Optional[float] = None,
                          scale: Optional[float] = None, q_offset: int = 0,
                          chunk: int = ATTN_CHUNK) -> torch.Tensor:
    """`attention_ref` one q chunk at a time: the same math, with the
    (Sq, Skv) logits held for `chunk` rows at once. A ragged Sq takes
    `attention_ref` whole."""
    Sq = q.shape[2]
    if Sq % chunk != 0:
        return attention_ref(q, k, v, causal, window, softcap, scale, q_offset)
    return torch.cat([attention_ref(q[:, :, i:i + chunk], k, v, causal, window, softcap,
                                    scale, q_offset + i)
                      for i in range(0, Sq, chunk)], dim=2)


# ---------------------------------------------------------------------------
# segment reduce (GNN message aggregation)
# ---------------------------------------------------------------------------


def segment_slots(seg_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """int64 segment ids with every id outside [0, num_segments) sent to a
    dump row at num_segments (dropped once the row is cut off)."""
    ok = (seg_ids >= 0) & (seg_ids < num_segments)
    return torch.where(ok, seg_ids.long(), num_segments)


def segment_sum_ref(values: torch.Tensor, seg_ids: torch.Tensor,
                    num_segments: int) -> torch.Tensor:
    """values (E, D), seg_ids (E,) -> (num_segments, D): out[s] = sum of the
    rows e with seg_ids[e] == s. Ids < 0 and >= num_segments are dropped and
    empty segments are 0. The sums and the result are float32 for float32
    and bfloat16 values (the Pallas kernel's out_dtype), float64 for float64."""
    acc = torch.promote_types(values.dtype, torch.float32)
    out = torch.zeros((num_segments + 1, values.shape[1]), dtype=acc, device=values.device)
    return out.index_add_(0, segment_slots(seg_ids, num_segments), values.to(acc))[:num_segments]


class _SegmentMax(torch.autograd.Function):
    """Per-slot maximum of values' rows, (num_slots, D), empty slots 0. Its
    gradient goes to the rows equal to their slot's maximum, split evenly
    among tied rows as the reference's (`jax.ops.segment_max`) is: the
    gradient of `scatter_reduce(include_self=False)` would count the zero it
    starts from as a tie wherever a slot's maximum is 0."""

    @staticmethod
    def forward(ctx, values, slots, num_slots):
        idx = slots[:, None].expand_as(values)  # a view, no copy
        out = values.new_zeros((num_slots, values.shape[1]))
        out.scatter_reduce_(0, idx, values, "amax", include_self=False)
        ctx.save_for_backward(values, slots, out)
        return out

    @staticmethod
    def backward(ctx, grad):
        values, slots, out = ctx.saved_tensors
        idx = slots[:, None].expand_as(values)
        win = values == out.gather(0, idx)
        ties = torch.zeros_like(out).scatter_add_(0, idx, win.to(out.dtype))
        share = torch.reciprocal(ties.clamp_(min=1))  # g * (1 / ties), as the reference
        return torch.where(win, grad.gather(0, idx) * share.gather(0, idx), 0), None, None


def segment_max_ref(values: torch.Tensor, seg_ids: torch.Tensor,
                    num_segments: int) -> torch.Tensor:
    """Per-segment maximum in values' dtype; dropped ids as in
    `segment_sum_ref`, and empty segments are 0 (not -inf). Differentiable:
    tied maxima share their segment's gradient evenly, dropped rows get 0."""
    slots = segment_slots(seg_ids, num_segments)
    return _SegmentMax.apply(values, slots, num_segments + 1)[:num_segments]


def segment_mean_ref(values: torch.Tensor, seg_ids: torch.Tensor,
                     num_segments: int) -> torch.Tensor:
    """`segment_sum_ref` divided by max(count, 1), tensor by tensor."""
    s = segment_sum_ref(values, seg_ids, num_segments)
    ones = torch.ones((values.shape[0], 1), dtype=s.dtype, device=values.device)
    return s / segment_sum_ref(ones, seg_ids, num_segments).clamp_(min=1)


# ---------------------------------------------------------------------------
# embedding bag (recsys lookup / storage-tier row fetch)
# ---------------------------------------------------------------------------


def embedding_bag_ref(table: torch.Tensor, indices: torch.Tensor,
                      weights: Optional[torch.Tensor] = None,
                      combine: str = "sum") -> torch.Tensor:
    """table (V, D), indices (B, L) with ids < 0 as padding, weights (B, L)
    or None (ones) -> (B, D) in table's dtype: out[b] = sum over valid l of
    w[b, l] * table[idx[b, l]]; "mean" divides by max(#valid, 1). Ids >= V
    read the last row (the reference's gather clamps). Sums and the
    division in float32 (float64 for a float64 table)."""
    if combine not in ("sum", "mean"):
        raise ValueError(f"combine must be 'sum' or 'mean', got {combine!r}")
    acc = torch.promote_types(table.dtype, torch.float32)
    ok = indices >= 0
    rows = table[indices.long().clamp(0, table.shape[0] - 1)].to(acc)  # (B, L, D)
    w = ok.to(acc) if weights is None else torch.where(ok, weights.to(acc), 0)
    out = (w[..., None] * rows).sum(1)
    if combine == "mean":
        out = out / ok.sum(-1, keepdim=True).to(acc).clamp_(min=1)
    return out.to(table.dtype)
