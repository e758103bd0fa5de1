"""Device mesh, Megatron-style parameter sharding and the collectives, on
torch.distributed.

The port of the JAX package's scaling layer (`smoltts_tpu/parallel/mesh.py`):

- a 2-D logical mesh ('data', 'model') over the processes of one
  `torch.distributed` job, one process (rank) per mesh point, laid out
  row-major (rank = data * n_model + model);
- the same partition specs for the DualAR parameter tree: wqkv/w1/w3/w13
  column-split, wo/w2 row-split, vocab-split output heads, replicated norms
  and embeddings (optionally row-split tables);
- where GSPMD inserts collectives from the layouts, the port calls them
  explicitly: a sum over the model axis after each row-parallel product, a
  gather over an axis (an all-reduce of a zero-filled buffer into which
  each rank wrote its slice, so gloo takes it on CUDA tensors and every rank
  receives the same bits), and the broadcast of a host object.

A `Mesh` built from coordinates alone (no process groups) is enough for
`shard_params`: the slicing is a pure function of the coordinates.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from smoltts_torch import resolve_device
from smoltts_torch.ops.quant import QTensor

DATA_AXIS = "data"
MODEL_AXIS = "model"

# A collective that waits longer than this raises instead of hanging.
COLLECTIVE_TIMEOUT = datetime.timedelta(seconds=600)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's view of an (n_data, n_model) mesh: its coordinates, the
    groups of its row (model axis) and column (data axis), a gloo group over
    every rank for host objects, and its device."""

    n_data: int
    n_model: int
    data: int = 0
    model: int = 0
    device: Optional[torch.device] = None
    data_group: Any = None
    model_group: Any = None
    host_group: Any = None

    def data_only(self) -> "Mesh":
        """The mesh with its model axis folded away: every rank of a row acts
        as a replica of the row's data shard (serving without tensor
        parallelism)."""
        return dataclasses.replace(self, n_model=1, model=0, model_group=None)

    def model_only(self) -> "Mesh":
        """The mesh with its data axis folded away (a batch every data rank
        holds whole, such as an admission's prefill)."""
        return dataclasses.replace(self, n_data=1, data=0, data_group=None)

    def model_sum(self, x: torch.Tensor) -> torch.Tensor:
        """Sum `x` over the model axis, in place, in its own dtype."""
        if self.model_group is None:
            _require_group(self.n_model, "model")
            return x
        dist.all_reduce(x, group=self.model_group)
        return x

    def data_gather(self, tensors: Sequence[Optional[torch.Tensor]], dim) -> list:
        """Concatenate each tensor's data-axis slices along `dim` (one int or
        one per tensor), in rank order, with one collective. None stays None."""
        return gather(self.data_group, self.n_data, self.data, tensors, dim)

    def broadcast_object(self, obj=None):
        """Rank 0's picklable `obj` on every rank (the gloo host group)."""
        box = [obj]
        dist.broadcast_object_list(box, src=0, group=self.host_group)
        return box[0]


def _require_group(n: int, axis: str) -> None:
    if n > 1:
        raise ValueError(f"the {axis} axis has {n} ranks but this Mesh holds no process "
                         "group for it (build it with make_mesh)")


def gather(group, n: int, index: int, tensors: Sequence[Optional[torch.Tensor]], dim) -> list:
    """Bit-exact gather over `group` (n ranks, this one at `index`) built from
    one all-reduce: every rank writes its tensors' bytes into its own row of
    a zero-filled int32 buffer, the sum of a word with zeros is the word, and
    each rank reads every row back. Every rank receives the same bits."""
    dims = [dim] * len(tensors) if isinstance(dim, int) else list(dim)
    if group is None:
        _require_group(n, "gathered")
        return list(tensors)
    live = [t for t in tensors if t is not None]
    dev = live[0].device
    flat = [t.contiguous().reshape(-1).view(torch.uint8) for t in live]
    offsets, total = [], 0
    for f in flat:  # 8-byte aligned, so each piece views back as its dtype
        offsets.append(total)
        total += -(-f.numel() // 8) * 8
    buf = torch.zeros((n, total), dtype=torch.uint8, device=dev)
    for f, o in zip(flat, offsets):
        buf[index, o : o + f.numel()] = f
    dist.all_reduce(buf.view(torch.int32), group=group)
    out, i = [], 0
    for t, d in zip(tensors, dims):
        if t is None:
            out.append(None)
            continue
        o, nb = offsets[i], flat[i].numel()
        parts = [buf[r, o : o + nb].view(t.dtype).reshape(t.shape) for r in range(n)]
        out.append(torch.cat(parts, dim=d))
        i += 1
    return out


def rank_device(device=None, rank: Optional[int] = None) -> torch.device:
    """This rank's device: `cuda:{local_rank % device_count}` for a CUDA
    request (None means CUDA; the local rank is LOCAL_RANK, else the rank),
    the CPU when asked."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        if rank is None:
            rank = dist.get_rank() if dist.is_initialized() else 0
        local = int(os.environ.get("LOCAL_RANK", rank))
        dev = torch.device("cuda", local % torch.cuda.device_count())
    return dev


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None, process_id: Optional[int] = None,
                     backend: Optional[str] = None, device=None) -> None:
    """Join the process group: `tcp://coordinator_address` with the given
    world size and rank, or, with no arguments, torchrun's environment
    (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK). The backend is "nccl" for
    a CUDA device (None means CUDA) and "gloo" for the CPU unless named; a
    failure raises, with no retry on another backend. Idempotent within a
    process."""
    if dist.is_initialized():
        return
    dev = rank_device(device, process_id)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    kwargs = dict(backend=backend, timeout=COLLECTIVE_TIMEOUT)
    if coordinator_address is not None:
        kwargs.update(init_method=f"tcp://{coordinator_address}", world_size=num_processes,
                      rank=process_id)
    else:
        kwargs["init_method"] = "env://"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(**kwargs)


def mesh_shape(n_data: int, n_model: int, n: int) -> Tuple[int, int]:
    """(n_data, n_model) of a mesh over n ranks, n_data -1 meaning all the
    rest; raises with the JAX package's message when the product is not n."""
    if n_data == -1:
        n_data = n // n_model
    if n_data * n_model != n:
        raise ValueError(f"mesh {n_data}x{n_model} != {n} devices")
    return n_data, n_model


def make_mesh(n_data: int = -1, n_model: int = 1, device=None) -> Mesh:
    """The (n_data, n_model) mesh over every rank of the initialized default
    group, ranks row-major as `np.arange(world).reshape(n_data, n_model)`.
    Every rank must call it, with the same arguments."""
    n = dist.get_world_size()
    n_data, n_model = mesh_shape(n_data, n_model, n)
    grid = np.arange(n).reshape(n_data, n_model)
    rank = dist.get_rank()
    data, model = (int(i) for i in np.argwhere(grid == rank)[0])
    # new_group is collective: every rank creates every group, in one order.
    model_groups = [dist.new_group(grid[i].tolist(), timeout=COLLECTIVE_TIMEOUT)
                    for i in range(n_data)]
    data_groups = [dist.new_group(grid[:, j].tolist(), timeout=COLLECTIVE_TIMEOUT)
                   for j in range(n_model)]
    host = dist.new_group(backend="gloo", timeout=COLLECTIVE_TIMEOUT)
    return Mesh(n_data=n_data, n_model=n_model, data=data, model=model,
                device=rank_device(device), data_group=data_groups[model],
                model_group=model_groups[data], host_group=host)


def make_multihost_mesh(n_model: int = 1, device=None) -> Mesh:
    """Host-aware mesh: the model axis stays within one host's ranks
    (LOCAL_WORLD_SIZE, as torchrun sets it); the data axis runs hosts
    outermost. torchrun numbers ranks host by host, so the row-major layout
    already does both."""
    world = dist.get_world_size()
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if world // local > 1 and local % n_model != 0:
        raise ValueError(
            f"model axis {n_model} must divide the {local} local devices: "
            "TP collectives must not cross DCN"
        )
    return make_mesh(-1, n_model, device=device)


# ---- partition specs --------------------------------------------------------


def param_partition_specs(params: dict, shard_tables: bool = False) -> dict:
    """The JAX package's PartitionSpec tree for a DualAR tree, each spec a
    tuple of axis names or None per tensor axis (() = replicated).

    Trunk weights carry a leading stacked-layer axis (never sharded).
    `shard_tables` row-splits `codebook_embeddings` and `fast_embeddings`;
    the tied text `embeddings` table stays replicated."""

    def trunk_specs(trunk: dict) -> dict:
        specs = {
            "attention_norm": (),
            "ffn_norm": (),
            "wqkv": (None, None, MODEL_AXIS),  # column parallel
            "wo": (None, MODEL_AXIS, None),  # row parallel
            "w1": (None, None, MODEL_AXIS),
            "w3": (None, None, MODEL_AXIS),
            "w2": (None, MODEL_AXIS, None),
            "w13": (None, None, MODEL_AXIS),  # fused [w1 | w3], split per half
        }
        if "wqkv_bias" in trunk:
            specs["wqkv_bias"] = (None, MODEL_AXIS)
        return {k: v for k, v in specs.items() if k in trunk}

    table = (MODEL_AXIS, None) if shard_tables else ()
    specs: dict = {
        "embeddings": (),
        "codebook_embeddings": table,
        "layers": trunk_specs(params["layers"]),
        "norm": (),
        "fast_embeddings": table,
        "fast_layers": trunk_specs(params["fast_layers"]),
        "fast_norm": (),
    }
    if "output" in params:
        specs["output"] = (None, MODEL_AXIS)  # vocab-split logits
    if "fast_project_in" in params:
        specs["fast_project_in"] = {"kernel": (), "bias": ()}
    fo = params["fast_output"]
    ndim = (fo.q if isinstance(fo, QTensor) else fo).dim()
    specs["fast_output"] = (None, None, MODEL_AXIS) if ndim == 3 else (None, MODEL_AXIS)
    return specs


def param_shardings(mesh: Mesh, params: dict, shard_tables: bool = False) -> dict:
    """The spec tree `param_partition_specs` gives; JAX's `param_shardings`
    binds each spec to its mesh, the port's rank holds the mesh itself."""
    return param_partition_specs(params, shard_tables=shard_tables)


def replicated(mesh: Optional[Mesh] = None) -> tuple:
    """The spec of a tensor every rank holds whole (JAX's `replicated(mesh)`
    is the NamedSharding of it)."""
    return ()


def batch_sharding(mesh: Optional[Mesh] = None, accumulate_steps: int = 1) -> tuple:
    """The spec of a training batch: [B, R, T] split over `data`, or [A, B,
    R, T] split on B under gradient accumulation (JAX's main.py picks the
    same two)."""
    return (None, DATA_AXIS) if accumulate_steps > 1 else (DATA_AXIS,)


# The spec of the slow trunk's [B, T, dim] activations under sequence
# parallelism (JAX's activation_sharding P('data', 'model', None)).
SEQUENCE_SHARDING = (DATA_AXIS, MODEL_AXIS, None)


def make_global_batch(batch: dict, mesh: Mesh, axis: int = 0) -> dict:
    """This rank's part of a global batch: each array's slice of the data
    axis along `axis` (`batch_sharding(...).index(DATA_AXIS)`), as a tensor
    on `mesh.device`. Model ranks of one row get the same rows."""
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(np.asarray(v) if not isinstance(v, torch.Tensor) else v)
        (a, b), = chunk_ranges(t.shape[axis], mesh.n_data, mesh.data, f"batch {k}")
        out[k] = t.narrow(axis, a, b - a).contiguous().to(resolve_device(mesh.device))
    return out


# ---- slicing ----------------------------------------------------------------


def kv_head_range(n_kv: int, n_model: int, model: int) -> Tuple[int, int]:
    """The kv heads rank `model` holds: its 1/n_model of them, or, when the
    model axis is wider than the kv heads, the one head its query heads read
    (replicated over the n_model / n_kv ranks that share it)."""
    if n_kv % n_model == 0:
        hk = n_kv // n_model
        return model * hk, (model + 1) * hk
    if n_model % n_kv == 0:
        kv = model // (n_model // n_kv)
        return kv, kv + 1
    raise ValueError(f"a model axis of {n_model} neither divides nor is a multiple of the "
                     f"{n_kv} kv heads")


def head_range(n_head: int, n_kv: int, n_model: int, model: int) -> Tuple[int, int, int, int]:
    """(q0, q1, kv0, kv1): the query and kv heads of rank `model`."""
    if n_head % n_model:
        raise ValueError(f"a model axis of {n_model} does not divide the {n_head} query heads")
    hq = n_head // n_model
    return (model * hq, (model + 1) * hq) + kv_head_range(n_kv, n_model, model)


def chunk_ranges(length: int, n: int, i: int, what: str) -> List[Tuple[int, int]]:
    if length % n:
        raise ValueError(f"{what}: axis of {length} does not split over {n} ranks")
    c = length // n
    return [(i * c, (i + 1) * c)]


def take_ranges(w, axis: int, ranges):
    """The columns `ranges` of `w` along `axis`, as a new contiguous tensor;
    a QTensor's scale is cut alongside where it spans that axis (a column
    split) and kept whole where it is 1 (a row split)."""
    def cut(t):
        return torch.cat([t.narrow(axis, a, b - a) for a, b in ranges], dim=axis)

    if isinstance(w, QTensor):
        length = w.q.shape[axis]
        scale = cut(w.scale) if w.scale.shape[axis] == length else w.scale
        return QTensor(q=cut(w.q), scale=scale)
    return cut(w)


def _axis_len(w, axis: int) -> int:
    return (w.q if isinstance(w, QTensor) else w).shape[axis]


def _local_leaf(w, spec: tuple, mesh: Mesh, name: str, heads: Optional[tuple]):
    """This rank's part of one leaf under `spec`. The fused leaves split per
    section: wqkv (and its bias) as [q heads | k heads | v heads] of the
    rank's heads, w13 as [w1 half | w3 half]."""
    for axis, ax_name in enumerate(spec):
        if ax_name is None:
            continue
        n, i = (mesh.n_model, mesh.model) if ax_name == MODEL_AXIS else (mesh.n_data, mesh.data)
        length = _axis_len(w, axis)
        if ax_name == MODEL_AXIS and name in ("wqkv", "wqkv_bias"):
            n_head, n_kv, hd = heads
            q0, q1, kv0, kv1 = head_range(n_head, n_kv, n, i)
            q, kvs = n_head * hd, n_kv * hd
            if length != q + 2 * kvs:
                raise ValueError(f"{name}: width {length} != ({n_head} + 2 x {n_kv}) x {hd}")
            ranges = [(q0 * hd, q1 * hd), (q + kv0 * hd, q + kv1 * hd),
                      (q + kvs + kv0 * hd, q + kvs + kv1 * hd)]
        elif ax_name == MODEL_AXIS and name == "w13":
            half = length // 2
            (a, b), = chunk_ranges(half, n, i, name)
            ranges = [(a, b), (half + a, half + b)]
        else:
            ranges = chunk_ranges(length, n, i, name)
        w = take_ranges(w, axis, ranges)
    return w


def _to(w, device):
    if device is None:
        return w
    if isinstance(w, QTensor):
        return QTensor(q=w.q.to(device), scale=w.scale.to(device))
    return w.to(device)


def _trunk_heads(cfg) -> dict:
    """(n_head, n_kv_head, head_dim) of each trunk, for the fused-qkv split."""
    return {"layers": (cfg.n_head, cfg.n_local_heads, cfg.head_dim),
            "fast_layers": (cfg.fast_n_head, cfg.fast_n_local_heads, cfg.fast_head_dim)}


def _shard_tree(tree, specs, mesh: Mesh, heads: Optional[tuple], name: str = ""):
    if isinstance(specs, dict):
        return {k: _shard_tree(tree[k], specs[k], mesh, heads, k) for k in specs}
    if all(a is None for a in specs):
        return _to(tree, mesh.device)
    return _to(_local_leaf(tree, specs, mesh, name, heads), mesh.device)


def shard_by_specs(params: dict, specs: dict, mesh: Mesh, cfg) -> dict:
    """This rank's local DualAR tree under the spec tree `specs` (a tuple
    spec is a leaf, QTensor leaves included), on `mesh.device` when it names
    one. `cfg` gives each trunk's heads, which the fused qkv split needs."""
    heads = _trunk_heads(cfg)
    return {k: _shard_tree(params[k], s, mesh, heads.get(k), k) for k, s in specs.items()}


def shard_params(params: dict, mesh: Mesh, shard_tables: bool = False, *, cfg) -> dict:
    """This rank's part of a DualAR tree under `param_partition_specs`."""
    return shard_by_specs(params, param_partition_specs(params, shard_tables), mesh, cfg)


# ---- putting a split tree back together --------------------------------------


def assemble_leaf(name: str, spec: tuple, parts: Sequence[torch.Tensor],
                  heads: Optional[tuple]) -> torch.Tensor:
    """The whole tensor from the model ranks' parts (rank order) of a leaf
    split under `spec`: the inverse of `_local_leaf`. A fused wqkv (and its
    bias) comes back as [q heads | k heads | v heads] from each rank's
    sections, a kv head shared by several ranks taken once; w13 as [w1 | w3]
    from each rank's halves; any other leaf is the parts in rank order."""
    axis = spec.index(MODEL_AXIS)
    n = len(parts)
    if name in ("wqkv", "wqkv_bias"):
        n_head, n_kv, hd = heads
        qs, kvs = [], {}
        for m, t in enumerate(parts):
            q0, q1, kv0, kv1 = head_range(n_head, n_kv, n, m)
            q, k, v = torch.split(t, [(q1 - q0) * hd, (kv1 - kv0) * hd, (kv1 - kv0) * hd], axis)
            qs.append(q)
            kvs.setdefault((kv0, kv1), (k, v))
        order = sorted(kvs)
        return torch.cat(qs + [kvs[r][0] for r in order] + [kvs[r][1] for r in order], axis)
    if name == "w13":
        halves = [torch.chunk(t, 2, axis) for t in parts]
        return torch.cat([h[0] for h in halves] + [h[1] for h in halves], axis)
    return torch.cat(list(parts), axis)


def _copy_dicts(tree):
    return {k: _copy_dicts(v) for k, v in tree.items()} if isinstance(tree, dict) else tree


def unshard_params(local: dict, mesh: Mesh, cfg, shard_tables: bool = False) -> dict:
    """The whole DualAR tree from this rank's part under
    `param_partition_specs` (the exact inverse of `shard_params`), gathered
    over the model axis with the bit-exact `gather`: every rank receives the
    same whole tree. A collective: every rank of the mesh calls it. Any tree
    shaped as the parameters (AdamW's moments) puts back together the same
    way."""
    specs = param_partition_specs(local, shard_tables)
    heads = _trunk_heads(cfg)
    split = []  # (path, name, spec, trunk) of every split leaf, gathered in one collective

    def find(tree, spec, path, trunk):
        if isinstance(spec, dict):
            for k in spec:
                find(tree[k], spec[k], path + (k,), trunk)
        elif mesh.n_model > 1 and MODEL_AXIS in spec:
            split.append((path, spec, trunk, tree))

    for k, s in specs.items():
        find(local[k], s, (k,), k)
    out = _copy_dicts(local)
    if not split:
        return out
    gathered = gather(mesh.model_group, mesh.n_model, mesh.model,
                      [t[None] for *_, t in split], 0)
    for (path, spec, trunk, _), parts in zip(split, gathered):
        node = out
        for k in path[:-1]:
            node = node[k]
        node[path[-1]] = assemble_leaf(path[-1], spec, list(parts), heads.get(trunk))
    return out
