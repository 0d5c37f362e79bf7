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


def _host_leaves(tree) -> List[Tuple[str, np.ndarray, str]]:
    return [(key, *_to_host(leaf)) for key, leaf in _flatten_with_paths(tree)]


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


def save_checkpoint(directory: str, step: int, tree, keep_last: int = 3) -> str:
    """Write `tree` as step `step` of `directory`; returns the step's path."""
    return _write(directory, step, _host_leaves(tree), keep_last)


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
def restore_checkpoint(directory: str, step: Optional[int], tree_like):
    """Copy step `step` (None: the latest) of `directory` into `tree_like`'s
    tensors, each cast to its dtype; returns (tree_like, step). Every key of
    `tree_like` must be in the manifest with its shape."""
    step = step if step is not None else latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {directory}")
    d = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        by_key = {m["key"]: m for m in json.load(f)["leaves"]}
    for key, like in _flatten_with_paths(tree_like):
        m = by_key[key]
        t = _load(os.path.join(d, m["file"]), m["dtype"])
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
