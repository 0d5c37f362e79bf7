"""Roofline terms of a step on H100s (the reference's `analysis/roofline.py`,
rebuilt for the port).

Three terms per (arch x shape x mesh):

  compute    = flops_per_device / the peak of the step's product dtype
  memory     = (major-op bytes - attention-score bytes
                + 2 x state bytes) per device / HBM rate
  collective = collective bytes per device / link rate

The reference reads XLA's cost analysis and parses its optimized HLO text.
The port has neither: `count_step` runs the port's own step eagerly on
`meta` tensors (shapes and dtypes, no memory, no device) and counts it:

  - flops by `torch.utils.flop_counter.FlopCounterMode` (products and
    convolutions), split by the products' operand dtype;
  - bytes by a dispatch mode that sums the operand and output bytes of
    every aten op that is not a view (the eager, unfused traffic: an upper
    bound) and of the major ops alone (`MAJOR_OPS`: products and
    convolutions, gathers, scatters, sorts and random draws, whose traffic
    a fusing compiler cannot remove; the reference's `_MAJOR_OPS`);
  - the attention scores' traffic apart (`score_dims`): on the card the
    flash kernels keep the scores on chip, so the memory term leaves it
    out, as the reference's does.

Eager counts are exact at any depth, so the reference's two-point depth
extrapolation is not needed.

A sharded step (one rank's own, run over a `fake` process group of the
mesh's size: `launch/dryrun.py`) is counted as rank 0 runs it, so its
flops and bytes are rank 0's (keys ending in `_rank0`), and the dispatch
mode also sees its collectives, the `c10d` ops:

  - collective bytes: each op's output bytes by kind (all-reduce,
    all-gather, all-to-all, reduce-scatter, broadcast), the data a device
    receives, as the reference's `parse_collectives` counts its HLO's
    output shapes (an all-reduce's payload once, not a ring's 2x);
  - between nodes: the bytes of the ops whose group spans more than one
    node of GPUS_PER_NODE cards (rank // GPUS_PER_NODE), at the node link's
    rate; the rest at NVLink's. Inter-pod bytes (groups spanning pods, the
    reference's split) are reported beside them;
  - the peak: the live storage bytes the step allocates, each output's
    storage added when it appears and taken away when it is freed, the
    largest sum (`temp_bytes`; the attention scores left out, as the
    flash kernels keep them on chip); the peak per device is that plus the
    arguments' bytes (the reference's temp + argument sizes).

A step run on one device (every cell the dry run cannot run per rank, and
any step counted without a process group) has no collectives: its
collective bytes and term are None, the bottleneck is taken over the
terms that were counted (`bottleneck_over`), and its flops and bytes are
divided evenly over the mesh (keys ending in `_even_split`). Per-device
state bytes are exact, from the sharding specs (`launch/dryrun.py`).

The plain attention path counts every (q, key) pair, masked or not; the
flash kernels skip the fully masked tiles, so a causal step's attention
flops are about twice what the card computes.
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import Dict, Iterable, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode, flop_registry

from repro_torch.kernels.ref import ATTN_CHUNK

# One H100 SXM5, dense: NVIDIA H100 Tensor Core GPU datasheet, SXM5 column
# (its tensor-core figures "with sparsity" are twice these).
PEAK_FLOPS = {
    "bf16": 989e12,  # BF16 / FP16 on the tensor cores
    "tf32": 495e12,  # TF32 on the tensor cores: float32 products with TF32 on
    "fp32": 67e12,  # FP32 on the CUDA cores: float32 products with TF32 off
}
HBM_BW = 3.35e12  # bytes/s, HBM3 (datasheet)
HBM_BYTES = 80e9  # 80 GB of HBM3 (datasheet)
NVLINK_BW = 450e9  # bytes/s a direction: NVLink 4, 900 GB/s a GPU both ways (datasheet)
NODE_LINK_BW = 50e9  # bytes/s a GPU between nodes: one 400 Gb/s NDR InfiniBand
#                      port a GPU (NVIDIA DGX H100 system's eight ConnectX-7 ports)
GPUS_PER_NODE = 8  # an NVIDIA DGX H100 system: eight H100s on one NVLink domain

# c10d ops (overload packet names, trailing "_" dropped) -> the HLO kind of
# the reference's `parse_collectives`
COLLECTIVE_KINDS = {
    "allreduce": "all-reduce", "allreduce_coalesced": "all-reduce",
    "allgather": "all-gather", "_allgather_base": "all-gather",
    "allgather_into_tensor_coalesced": "all-gather", "allgather_coalesced": "all-gather",
    "alltoall": "all-to-all", "alltoall_base": "all-to-all",
    "reduce_scatter": "reduce-scatter", "_reduce_scatter_base": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "broadcast": "broadcast",
}

# aten ops (overload packet names, trailing "_" dropped) whose operands and
# outputs stream through HBM whatever a compiler fuses: the reference's
# dot, convolution, gather, scatter, sort and rng
MAJOR_OPS = frozenset({
    "mm", "addmm", "bmm", "baddbmm", "addbmm", "mv", "addmv", "dot", "vdot",
    "convolution", "_convolution", "convolution_backward",
    "gather", "index_select", "embedding", "embedding_dense_backward", "index", "take",
    "scatter", "scatter_add", "scatter_reduce", "index_add", "index_put",
    "_index_put_impl", "index_copy", "masked_scatter",
    "sort", "topk",
    "normal", "uniform", "bernoulli", "random", "exponential", "randn", "rand", "randint",
    "randperm", "multinomial", "native_dropout",
})
# allocations: no bytes move
_FREE = frozenset({"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided"})


def _op_name(func) -> str:
    """The op's overload packet name, an in-place op's trailing "_" dropped."""
    return func.overloadpacket.__name__.rstrip("_")


def product_peak(dtype: torch.dtype, tf32: bool = False) -> str:
    """The `PEAK_FLOPS` key of products in `dtype`."""
    if dtype in (torch.bfloat16, torch.float16):
        return "bf16"
    if dtype == torch.float32:
        return "tf32" if tf32 else "fp32"
    raise ValueError(f"no H100 peak for products in {dtype}")


@dataclasses.dataclass
class StepCount:
    """One step's counts: the whole step's, or rank 0's where the step runs
    per rank (`per_rank`)."""

    flops: float  # FlopCounterMode's total
    flops_by_dtype: Dict[str, float]  # the same flops by the products' operand dtype
    bytes: float  # every non-view aten op: operands + outputs (eager, unfused)
    major_bytes: float  # MAJOR_OPS only
    score_bytes: float  # of major_bytes: attention score tensors
    ops: int  # aten ops dispatched
    per_rank: bool = False  # one rank's own step, over a process group
    collective_bytes: float = 0.0  # c10d output bytes
    inter_node_bytes: float = 0.0  # of which over groups spanning nodes
    inter_pod_bytes: float = 0.0  # of which over groups spanning pods
    collectives: Dict[str, int] = dataclasses.field(default_factory=dict)  # ops by kind
    collective_bytes_by_kind: Dict[str, float] = dataclasses.field(default_factory=dict)
    temp_bytes: float = 0.0  # the peak of the live storage the step allocated

    def peak(self, tf32: bool = False) -> str:
        """The peak of the dtype that carries most of the product flops."""
        if not self.flops_by_dtype:
            return "bf16"
        dtype = max(self.flops_by_dtype, key=self.flops_by_dtype.get)
        return product_peak(getattr(torch, dtype), tf32)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _group_ranks(args) -> Optional[list]:
    """The global ranks of the process group among a c10d op's arguments
    (a boxed `ProcessGroup`), or None where it cannot be read."""
    import torch.distributed as dist

    unbox = getattr(dist.ProcessGroup, "unbox", None)
    for a in args:
        if isinstance(a, torch.ScriptObject) and unbox is not None:
            return dist.get_process_group_ranks(unbox(a))
    return None


class _Tally(TorchDispatchMode):
    def __init__(self, score_dims: Optional[Tuple[int, int]], pod_size: Optional[int]):
        super().__init__()
        self.count = StepCount(0.0, {}, 0.0, 0.0, 0.0, 0)
        self.pod_size = pod_size
        if score_dims is None:
            self.score_pairs = set()
        else:
            sq, skv = score_dims
            self.score_pairs = {(r, skv) for r in (sq, ATTN_CHUNK)}
            self.score_pairs |= {(b, a) for a, b in self.score_pairs}
        self.live = 0  # bytes of the storages the step allocated, still alive
        self.tracked = set()  # their ids

    def is_score(self, t: torch.Tensor) -> bool:
        return t.dim() >= 3 and tuple(t.shape[-2:]) in self.score_pairs

    def _freed(self, sid: int, nbytes: int) -> None:
        self.tracked.discard(sid)
        self.live -= nbytes

    def _allocated(self, outs, ins) -> None:
        """Track each output storage that no input holds and that is not
        tracked yet; the peak of the live sum is `temp_bytes`."""
        seen = {t.untyped_storage()._cdata for t in ins}
        for t in outs:
            st = t.untyped_storage()
            sid = st._cdata
            if sid in seen or sid in self.tracked or self.is_score(t):
                continue
            seen.add(sid)
            self.tracked.add(sid)
            self.live += st.nbytes()
            weakref.finalize(st, self._freed, sid, st.nbytes())
        self.count.temp_bytes = max(self.count.temp_bytes, float(self.live))

    def _collective(self, name: str, args) -> None:
        c = self.count
        kind = COLLECTIVE_KINDS.get(name, name)
        out = [t for t in tree_leaves(args[0]) if isinstance(t, torch.Tensor)]
        b = float(sum(_nbytes(t) for t in out))
        c.collective_bytes += b
        c.collectives[kind] = c.collectives.get(kind, 0) + 1
        c.collective_bytes_by_kind[kind] = c.collective_bytes_by_kind.get(kind, 0.0) + b
        ranks = _group_ranks(args)
        if ranks is None or len({r // GPUS_PER_NODE for r in ranks}) > 1:
            c.inter_node_bytes += b  # a group it cannot read counts as the slower link's
        if self.pod_size and (ranks is None or len({r // self.pod_size for r in ranks}) > 1):
            c.inter_pod_bytes += b

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        c = self.count
        c.ops += 1
        name = _op_name(func)
        if func.namespace == "c10d":
            if name != "barrier":
                self._collective(name, args)
            return out
        if func.is_view:
            return out
        ins = [t for t in tree_leaves((args, kwargs)) if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        self._allocated(outs, ins)
        if name in _FREE:
            return out
        tensors = ins + outs
        moved = sum(_nbytes(t) for t in tensors)
        c.bytes += moved
        if name in MAJOR_OPS:
            c.major_bytes += moved
            c.score_bytes += sum(_nbytes(t) for t in tensors if self.is_score(t))
        packet = func.overloadpacket
        if packet in flop_registry:
            f = flop_registry[packet](*args, **kwargs, out_val=out)
            dtype = str(next(t for t in tensors if t.is_floating_point()).dtype)[6:]
            c.flops_by_dtype[dtype] = c.flops_by_dtype.get(dtype, 0.0) + float(f)
        return out


def count_step(fn, args: Iterable, score_dims: Optional[Tuple[int, int]] = None,
               pod_size: Optional[int] = None, per_rank: bool = False):
    """(fn(*args), StepCount): the step run once under the counters.
    score_dims (Sq, Skv): tensors of three or more dims whose last two are
    (Sq or an `attention_chunked_ref` chunk, Skv), either way round, are
    attention scores. per_rank: fn is one rank's step over a process group
    (rank 0's, in the dry run); pod_size: the ranks a pod, for the
    inter-pod split of its collectives."""
    tally = _Tally(score_dims, pod_size)
    tally.count.per_rank = per_rank
    with FlopCounterMode(display=False) as flops, tally:
        out = fn(*args)
    tally.count.flops = float(flops.get_total_flops())
    return out, tally.count


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    n_devices: int
    flops_per_device: float  # counted flops: rank 0's, or split evenly over the mesh
    bytes_per_device: float  # eager, unfused bytes, likewise
    adj_bytes_per_device: float  # major-op bytes, likewise
    score_bytes_per_device: float  # attention-score bytes among them, likewise
    collective_bytes: Optional[float]  # rank 0's; None: a step run on one device
    inter_pod_bytes: Optional[float]
    model_flops: float  # analytic 6ND / 2ND
    peak_memory_bytes: Optional[float]  # rank 0's arguments + temporaries; None on one device
    peak_state_bytes: float  # per device: state read (arguments) + written (outputs)
    collectives: Optional[Dict[str, int]]
    peak: str = "bf16"  # PEAK_FLOPS key of the step's products
    inter_node_bytes: Optional[float] = None  # of collective_bytes; None: inter_pod_bytes
    counted_on: str = "even_split"  # "rank0": one rank's own counts

    @property
    def peak_flops(self) -> float:
        return PEAK_FLOPS[self.peak]

    @property
    def t_compute(self) -> float:
        return self.flops_per_device / self.peak_flops

    @property
    def t_memory_eager(self) -> float:
        """Every op's operands and outputs through HBM: the eager bound."""
        return self.bytes_per_device / HBM_BW

    @property
    def t_memory(self) -> float:
        """Major-op traffic, minus the attention scores (the flash kernels
        keep them on chip), plus one read and one write of the state."""
        state_rw = 2.0 * self.peak_state_bytes
        return (max(self.adj_bytes_per_device - self.score_bytes_per_device, 0.0)
                + state_rw) / HBM_BW

    @property
    def t_collective(self) -> Optional[float]:
        if self.collective_bytes is None:
            return None
        inter = self.inter_node_bytes if self.inter_node_bytes is not None else \
            (self.inter_pod_bytes or 0.0)
        return (self.collective_bytes - inter) / NVLINK_BW + inter / NODE_LINK_BW

    def _terms(self) -> Dict[str, float]:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return {k: v for k, v in terms.items() if v is not None}

    @property
    def bottleneck(self) -> str:
        terms = self._terms()
        return max(terms, key=terms.get)

    @property
    def useful_flops_fraction(self) -> float:
        """MODEL_FLOPS / (counted flops summed over devices)."""
        total = self.flops_per_device * self.n_devices
        return self.model_flops / total if total else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Achievable MFU bound: useful flops / (bound time x peak x cards)."""
        t = max(self._terms().values())
        if t <= 0:
            return 0.0
        return self.model_flops / (t * self.peak_flops * self.n_devices)

    def row(self) -> dict:
        on = self.counted_on
        return {
            "arch": self.arch,
            "shape": self.shape,
            "mesh": self.mesh,
            "peak": self.peak,
            "peak_flops": self.peak_flops,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_memory_eager_s": self.t_memory_eager,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "bottleneck_over": sorted(self._terms()),
            "model_flops": self.model_flops,
            f"flops_per_dev_{on}": self.flops_per_device,
            f"eager_bytes_per_dev_{on}": self.bytes_per_device,
            f"major_bytes_per_dev_{on}": self.adj_bytes_per_device,
            f"score_bytes_per_dev_{on}": self.score_bytes_per_device,
            "useful_flops_frac": self.useful_flops_fraction,
            "roofline_fraction": self.roofline_fraction,
            "state_rw_gb_per_dev": self.peak_state_bytes / 1e9,
            "peak_mem_gb": None if self.peak_memory_bytes is None
            else self.peak_memory_bytes / 1e9,
            "collectives": self.collectives,
            "collective_bytes": self.collective_bytes,
            "inter_node_bytes": self.inter_node_bytes,
            "inter_pod_bytes": self.inter_pod_bytes,
        }


def build_report(arch: str, shape: str, mesh_name: str, n_devices: int, count: StepCount,
                 state_rw_bytes: float, model_flops: float, tf32: bool = False,
                 argument_bytes: Optional[float] = None) -> RooflineReport:
    """The report of one counted step over `n_devices` (`state_rw_bytes`
    per device). A step counted per rank (its collectives counted) is rank
    0's: its counts stand as they are, and its peak is `argument_bytes`
    (per device) plus its temporaries; a step run on one device is split
    evenly and has no collective term and no peak."""
    per_rank = count.per_rank
    n = 1.0 if per_rank else float(n_devices)
    return RooflineReport(
        arch=arch, shape=shape, mesh=mesh_name, n_devices=n_devices,
        flops_per_device=count.flops / n, bytes_per_device=count.bytes / n,
        adj_bytes_per_device=count.major_bytes / n,
        score_bytes_per_device=count.score_bytes / n,
        collective_bytes=count.collective_bytes if per_rank else None,
        inter_pod_bytes=count.inter_pod_bytes if per_rank else None,
        model_flops=model_flops,
        peak_memory_bytes=(argument_bytes or 0.0) + count.temp_bytes if per_rank else None,
        peak_state_bytes=float(state_rw_bytes),
        collectives=dict(count.collectives) if per_rank else None,
        peak=count.peak(tf32),
        inter_node_bytes=count.inter_node_bytes if per_rank else None,
        counted_on="rank0" if per_rank else "even_split")


def model_flops_share(model_flops: float, seconds: float, peak: str, n_devices: int = 1) -> float:
    """The share of the cards' peak that a step's model flops took:
    model_flops / (seconds x peak x cards), the benchmark's `mfu`."""
    return model_flops / (seconds * PEAK_FLOPS[peak] * n_devices)
