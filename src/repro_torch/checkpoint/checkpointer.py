"""Checkpoint and restore with a manifest (the reference's
`checkpoint/checkpointer.py`, in the same layout on disk).

  - a tree (nested dicts, lists and dataclasses such as `TrainState`) is
    flattened to path-keyed leaves ("params/embed", "opt_state/count",
    "step"; dict keys sorted, list items by index, dataclass fields by
    name); each leaf is one .npy in a `step_%08d` directory, with a
    manifest.json of keys, files, shapes, dtypes and the step;
  - a step is written to a temporary directory and published by
    `os.rename`, so a killed run never leaves half a checkpoint;
  - all but the `keep_last` newest steps are removed;
  - the `Checkpointer` copies the tree to the host first, then writes it
    from a background thread while training goes on.

numpy has no bfloat16: a bf16 leaf is stored as its uint16 bits with
"dtype": "bfloat16" in the manifest, and restored bit for bit (the
reference writes the array's own dtype). Restore copies each leaf INTO the
tensors of `tree_like` (cast to their dtype, on their device) and returns
that tree: a training state keeps its parameters' identity, and no second
copy of it is made on the device.

A sharded state (this rank's shards on a `ProcessMesh`, with a spec tree
of the same structure, e.g. `TrainState(param specs, opt_state_pspecs(..),
())`) is saved as whole leaves in the same manifest: every rank gathers
each leaf in turn (`mesh_utils.gather`) and rank 0 writes, so the
checkpoint reads like one device's. Restore with a mesh and specs reads
each whole leaf and copies this rank's block of it (`local_shard`), from
a checkpoint written on any mesh or on one device (the reference's
`restore_checkpoint(..., shardings=)`).
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import tempfile
import threading
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

BF16 = "bfloat16"


def _flatten_with_paths(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), x) for i, x in enumerate(tree)]
    elif dataclasses.is_dataclass(tree):
        items = [(f.name, getattr(tree, f.name)) for f in dataclasses.fields(tree)]
    else:
        return [(prefix, tree)]
    return [kv for k, x in items for kv in _flatten_with_paths(x, f"{prefix}/{k}" if prefix else k)]


def _to_host(leaf) -> Tuple[np.ndarray, str]:
    """A copy of the leaf on the host and its dtype's name (bf16 as bits)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), BF16
        arr = t.numpy()
    else:
        arr = np.array(leaf)
    return arr, str(arr.dtype)


def _host_leaves(tree, mesh=None, specs=None) -> List[Tuple[str, np.ndarray, str]]:
    """(key, host array, dtype name) a leaf; on a mesh each leaf is gathered
    whole first (every rank takes part; only rank 0 keeps the copy)."""
    if mesh is None:
        return [(key, *_to_host(leaf)) for key, leaf in _flatten_with_paths(tree)]
    from repro_torch.distributed.mesh_utils import gather

    out = []
    with torch.no_grad():
        for key, leaf in _flatten_with_paths(tree):
            whole = gather(leaf, _spec_at(specs, key), mesh) \
                if isinstance(leaf, torch.Tensor) else leaf
            if mesh.rank == 0:
                out.append((key, *_to_host(whole)))
    return out


def _spec_at(specs, key: str):
    """The spec of the leaf at path `key` of a spec tree that mirrors the
    state's structure (dicts, lists, dataclasses; spec tuples at its leaves)."""
    node = specs
    for part in key.split("/") if key else ():
        if isinstance(node, dict):
            node = node[part]
        elif isinstance(node, list):
            node = node[int(part)]
        else:
            node = getattr(node, part)
    return node


def _write(directory: str, step: int, leaves, keep_last: int) -> str:
    os.makedirs(directory, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=directory, prefix=f".tmp_step_{step}_")
    manifest = {"step": step, "leaves": []}
    for key, arr, dtype in leaves:
        fname = key.replace("/", "__") + ".npy"
        np.save(os.path.join(tmp, fname), arr)
        manifest["leaves"].append(
            {"key": key, "file": fname, "shape": list(arr.shape), "dtype": dtype})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    final = os.path.join(directory, f"step_{step:08d}")
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic publish
    steps = sorted(d for d in os.listdir(directory) if d.startswith("step_"))
    for d in steps[:-keep_last]:
        shutil.rmtree(os.path.join(directory, d), ignore_errors=True)
    return final


def save_checkpoint(directory: str, step: int, tree, keep_last: int = 3, mesh=None,
                    specs=None) -> str:
    """Write `tree` as step `step` of `directory`; returns the step's path.
    A sharded tree (`mesh`, `specs`): every rank calls it, rank 0 writes
    the whole leaves, and every rank returns once the step is published."""
    if mesh is None:
        return _write(directory, step, _host_leaves(tree), keep_last)
    import torch.distributed as dist

    leaves = _host_leaves(tree, mesh, specs)
    path = _write(directory, step, leaves, keep_last) if mesh.rank == 0 else \
        os.path.join(directory, f"step_{step:08d}")
    dist.barrier()
    return path


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(directory) if d.startswith("step_")]
    return max(steps) if steps else None


def _load(path: str, dtype: str) -> torch.Tensor:
    arr = np.load(path)
    if dtype == BF16:  # its bits, whatever numpy calls the 2-byte type
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.uint16).view(np.int16)) \
            .view(torch.bfloat16)
    return torch.from_numpy(arr)


@torch.no_grad()
def restore_checkpoint(directory: str, step: Optional[int], tree_like, mesh=None, specs=None):
    """Copy step `step` (None: the latest) of `directory` into `tree_like`'s
    tensors, each cast to its dtype; returns (tree_like, step). Every key of
    `tree_like` must be in the manifest with its shape. With a `mesh` and
    `specs`, `tree_like` holds this rank's shards: each is this rank's
    block (`local_shard`) of the stored whole leaf."""
    step = step if step is not None else latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {directory}")
    d = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        by_key = {m["key"]: m for m in json.load(f)["leaves"]}
    for key, like in _flatten_with_paths(tree_like):
        m = by_key[key]
        t = _load(os.path.join(d, m["file"]), m["dtype"])
        if mesh is not None:
            from repro_torch.distributed.mesh_utils import local_shard

            t = local_shard(t, _spec_at(specs, key), mesh)
        if tuple(t.shape) != tuple(like.shape):
            raise ValueError(f"{key}: {tuple(t.shape)} vs {tuple(like.shape)}")
        like.copy_(t)
    return tree_like, step


@dataclasses.dataclass
class Checkpointer:
    """Async checkpointer: `save` copies to the host and returns; a thread
    writes. One write at a time (a save waits for the previous one)."""

    directory: str
    keep_last: int = 3

    def __post_init__(self):
        self._thread: Optional[threading.Thread] = None

    def save(self, step: int, tree, blocking: bool = False) -> None:
        host = _host_leaves(tree)  # the device-to-host copy, before training goes on
        self.wait()
        self._thread = threading.Thread(target=_write,
                                        args=(self.directory, step, host, self.keep_last))
        self._thread.start()
        if blocking:
            self.wait()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def restore_latest(self, tree_like):
        return restore_checkpoint(self.directory, None, tree_like)
