"""The port's differentiable collectives (`repro_torch.distributed.collectives`),
its flattened mesh groups, `local_shard`, `shard_constraint`,
`shard_graph_batch` and `init_mesh`'s backend, on the CPU.

Four gloo ranks on a (data, model) mesh of (2, 2) run every collective over
"data", "model" and the flattened pair, forward and backward, with a loss
whose weights differ by rank; each result is held to the transpose
shard_map takes (psum: the identity; enter: a psum; pmean and invariant:
over the group size; all_gather: a reduce-scatter by sum; gather_invariant:
the rank's own block of its cotangent; all_to_all: the reverse exchange). Gloo takes every dtype the port exchanges on CPU tensors.
"""

import numpy as np
import pytest
import torch
from types import SimpleNamespace

import _sharded_cases as C
import _torch_dist as D
import _torch_sharded as S
from _torch_threads import one_thread  # noqa: F401 (autouse: one intra-op thread)
from repro_torch.distributed.mesh import init_mesh
from repro_torch.distributed.mesh_utils import set_mesh_rules, shard_constraint
from repro_torch.models.gnn.message_passing import shard_graph_batch

MESH = (2, 2)
GROUPS = {"data": ("data",), "model": ("model",), "data+model": ("data", "model")}


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    return D.spawn(S.collectives_all, C.WORLD, str(tmp_path_factory.mktemp("gloo")),
                   timeout=300)


def _members(rank: int, axes) -> list:
    """The ranks of `rank`'s group over `axes`, ascending."""
    c = C.mesh_coords(rank, MESH)
    return [r for r in range(C.WORLD)
            if all(C.mesh_coords(r, MESH)[a] == c[a] for a in C.AXES if a not in axes)]


def _x(r):
    return np.arange(6, dtype=np.float32).reshape(2, 3) + 10 * r


def test_coords_and_groups(port):
    for r, got in enumerate(port):
        assert got["backend"] == "gloo"
        c = C.mesh_coords(r, MESH)
        np.testing.assert_array_equal(got["coords"], [c["data"], c["model"], r])
        for key, axes in GROUPS.items():
            np.testing.assert_array_equal(got[f"ranks/{key}"], _members(r, axes))


@pytest.mark.parametrize("key", list(GROUPS))
@pytest.mark.parametrize("op", ["psum", "enter", "pmean", "invariant", "all_gather0",
                                "all_gather1", "gather_invariant0", "gather_invariant1",
                                "all_to_all"])
def test_collective_forward_and_transpose(port, key, op):
    for r, got in enumerate(port):
        members = _members(r, GROUPS[key])
        n, me = len(members), members.index(r)
        y, dx = got[f"{op}/{key}/y"], got[f"{op}/{key}/dx"]
        if op == "all_to_all":
            xs = [np.arange(n * 2, dtype=np.float32).reshape(n, 2) + 100 * m for m in members]
            ws = [np.arange(n * 2, dtype=np.float32).reshape(n, 2) + m for m in members]
            np.testing.assert_array_equal(y, np.stack([xs[s][me] for s in range(n)]))
            np.testing.assert_array_equal(dx, np.stack([ws[s][me] for s in range(n)]))
            continue
        w = lambda m, shape: np.arange(np.prod(shape), dtype=np.float32).reshape(shape) * (m + 1)
        if "gather" in op:
            dim = int(op[-1])
            np.testing.assert_array_equal(y, np.concatenate([_x(m) for m in members], dim))
            blocks = [np.split(w(m, y.shape), n, dim)[me] for m in members]
            # all_gather sums every rank's block; gather_invariant takes its own
            want = np.sum(blocks, 0) if op.startswith("all") else blocks[members.index(r)]
            np.testing.assert_array_equal(dx, want)
            continue
        total = np.sum([_x(m) for m in members], 0)
        want_y = {"psum": total, "enter": _x(r), "pmean": total / n, "invariant": _x(r)}[op]
        own = w(r, y.shape)
        want_dx = {"psum": own, "enter": np.sum([w(m, y.shape) for m in members], 0),
                   "pmean": own / n, "invariant": own / n}[op]
        np.testing.assert_allclose(y, want_y, rtol=1e-7)
        np.testing.assert_allclose(dx, want_dx, rtol=1e-7)


@pytest.mark.parametrize("dtype", [str(d).split(".")[1] for d in S.DTYPES])
def test_gloo_takes_every_dtype_on_cpu_tensors(port, dtype):
    """all_to_all_single, all_gather, all_reduce (not for bool) and
    broadcast from rank 1 of (arange(8) + rank)."""
    base = [np.arange(8) + r for r in range(C.WORLD)]
    if dtype == "bool":
        base = [b.astype(bool) for b in base]
    cast = lambda a: np.asarray(a).astype(np.float32)
    for r, got in enumerate(port):
        raw = got[f"raw/{dtype}"]
        a2a = np.concatenate([np.split(base[s], C.WORLD)[r] for s in range(C.WORLD)])
        red = base[r] if dtype == "bool" else np.sum(base, 0)
        if dtype == "uint8":
            red = red % 256
        np.testing.assert_array_equal(raw[0], cast(a2a))
        np.testing.assert_array_equal(raw[1], cast(base[0]))
        np.testing.assert_array_equal(raw[2], cast(red))
        np.testing.assert_array_equal(raw[3], cast(base[1]))


def test_local_shard_blocks(port):
    x = np.arange(4 * 8 * 2, dtype=np.float32).reshape(4, 8, 2)
    specs = [("data", None), (None, "model"), (("data", "model"),), ("model", "data"),
             (None, ("data", "model"), None)]
    for r, got in enumerate(port):
        for i, spec in enumerate(specs):
            np.testing.assert_array_equal(got[f"shard/{i}"], C.block(x, spec, r, MESH))


def test_shard_constraint_resolves_and_returns_the_tensor():
    x = torch.zeros(4, 6)
    assert shard_constraint(x, ("batch", "mlp")) is x  # no rules
    with set_mesh_rules(SimpleNamespace(shape={"data": 2, "model": 2})):
        assert shard_constraint(x, ("batch", "mlp")) is x
        assert shard_constraint(x, ("nodes",)) is x
        with pytest.raises(ValueError):
            shard_constraint(x, ("batch", "mlp", None))


def test_shard_graph_batch_keeps_every_value():
    batch = {"node_feat": torch.randn(6, 3), "node_pos": torch.randn(6, 3),
             "src": torch.arange(10), "dst": torch.arange(10), "labels": torch.arange(6)}
    for rules in (None, SimpleNamespace(shape={"data": 2, "model": 2})):
        if rules is None:
            out = shard_graph_batch(batch)
        else:
            with set_mesh_rules(rules):
                out = shard_graph_batch(batch)
        assert out is not batch and out.keys() == batch.keys()
        assert all(out[k] is batch[k] for k in batch)


def test_init_mesh_refuses_a_backend_the_device_cannot_take():
    """NCCL for CPU tensors, or a backend the port does not use, raises
    before any process group starts (the ranks above ask for gloo by name)."""
    for device, backend in (("cpu", "nccl"), ("cpu", "mpi")):
        with pytest.raises(ValueError):
            init_mesh((1,), ("data",), device, backend=backend)
