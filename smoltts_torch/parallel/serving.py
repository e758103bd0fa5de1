"""Mesh serving: decode and vocoder state laid out over a `Mesh`.

The port of `smoltts_tpu/parallel/serving.py`. Every per-stream axis
(decode slots) is split over `data`: streams are independent, so a rank
steps only its own slots and the frame step runs no collective on that
axis. With tensor parallelism the slow trunk is also split Megatron-style
over `model` (parallel/mesh.py): each rank holds its query heads, the kv
heads they read and its part of every row- and column-parallel weight, and
the decode path sums over `model` after each row-parallel product.

Where GSPMD gives a `pallas_call`'s operands whole to every device, the
serving layout does so explicitly: everything the fast micro-loop kernel
reads (`fast_layers`, `fast_output`, `fast_embeddings`, `fast_project_in`)
stays replicated, so K1 runs the whole fast loop on each rank with no
collective inside it. Mimi parameters replicate and the vocoder runs no
collective.

Each function returns this rank's local tree; a step run on it with the
same mesh (`mesh.data_only()` without tensor parallelism) computes this
rank's slots.
"""

from __future__ import annotations

from typing import Optional

import torch

from smoltts_torch.codec.mimi import MimiStreamState
from smoltts_torch.interop import tree_map
from smoltts_torch.lm.decode import DecodeState
from smoltts_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    chunk_ranges,
    kv_head_range,
    param_partition_specs,
    replicated,
    shard_by_specs,
    take_ranges,
)

_FAST_LEAVES = ("fast_layers", "fast_output", "fast_embeddings", "fast_project_in")


def serving_partition_specs(params: dict, shard_tables: bool = False) -> dict:
    """`param_partition_specs` with every leaf the fast micro-loop kernel
    reads replicated."""
    specs = param_partition_specs(params, shard_tables=shard_tables)
    for key in _FAST_LEAVES:
        if key in specs:
            spec = specs[key]
            specs[key] = ({k: replicated() for k in spec} if isinstance(spec, dict)
                          else replicated())
    return specs


def decode_state_shardings(state: DecodeState) -> DecodeState:
    """Specs for DecodeState: slots over `data`, kv heads over `model`.

    k/v/k_tail/v_tail are [L, B, H, S|W, hd] and the kv8 scales [L, B, H,
    S] (slots axis 1, heads axis 2); the bookkeeping vectors are [B, ...]."""
    kv = (None, DATA_AXIS, MODEL_AXIS)
    b0 = (DATA_AXIS,)
    return DecodeState(
        k=kv, v=kv, k_tail=kv, v_tail=kv,
        tail_pos=b0, flushed=b0, phase=(), pos=b0,
        prev_tokens=b0, finished=b0,
        k_scale=None if state.k_scale is None else kv,
        v_scale=None if state.v_scale is None else kv,
    )


def mimi_state_shardings(state: MimiStreamState) -> MimiStreamState:
    """Specs for MimiStreamState: slots over `data`. Conv tails and SEANet
    buffers are [B, ...]; the codec transformer ring and its tail are
    [L, B, W, H, hd] (slots axis 1)."""
    b0 = (DATA_AXIS,)
    ring = (None, DATA_AXIS)
    t = state.transformer
    transformer = t._replace(
        k=ring, v=ring, slot_pos=b0, k_tail=ring, v_tail=ring,
        tail_abs=b0, t_phase=(), pos=b0,
        k_scale=None if t.k_scale is None else ring,
        v_scale=None if t.v_scale is None else ring,
    )
    decoder = tree_map(lambda _: b0, state.decoder)
    return MimiStreamState(upsample_tail=b0, transformer=transformer, decoder=decoder)


def _local(t: Optional[torch.Tensor], spec, mesh: Mesh) -> Optional[torch.Tensor]:
    """This rank's part of one state tensor: slots in contiguous blocks, kv
    heads as `kv_head_range` gives them (a head shared by several model
    ranks is held by each)."""
    if t is None:
        return None
    for axis, name in enumerate(spec):
        if name == DATA_AXIS:
            t = take_ranges(t, axis, chunk_ranges(t.shape[axis], mesh.n_data, mesh.data, "slots"))
        elif name == MODEL_AXIS:
            t = take_ranges(t, axis, [kv_head_range(t.shape[axis], mesh.n_model, mesh.model)])
    return t if mesh.device is None else t.to(mesh.device)


def _zip_map(fn, state, specs):
    """fn(tensor or None, spec) over a state tree (NamedTuples, lists,
    dicts) and its spec tree, walking the state's structure."""
    if state is None or isinstance(state, torch.Tensor):
        return fn(state, specs)
    if isinstance(state, dict):
        return {k: _zip_map(fn, v, specs[k]) for k, v in state.items()}
    items = [_zip_map(fn, v, s) for v, s in zip(state, specs)]
    return type(state)(*items) if hasattr(state, "_fields") else type(state)(items)


def _specs(state):
    if isinstance(state, DecodeState):
        return decode_state_shardings(state)
    return mimi_state_shardings(state)


def shard_decode_state(state: DecodeState, mesh: Mesh) -> DecodeState:
    return _zip_map(lambda t, s: _local(t, s, mesh), state, _specs(state))


def shard_mimi_state(state: MimiStreamState, mesh: Mesh) -> MimiStreamState:
    return _zip_map(lambda t, s: _local(t, s, mesh), state, _specs(state))


def take_slots(state, rows: torch.Tensor):
    """The slots `rows` (an index tensor) of a DecodeState or
    MimiStreamState: every field that carries slots, selected on its slot
    axis; the others as they are."""
    def one(t, spec):
        if t is None or DATA_AXIS not in spec:
            return t
        return t.index_select(spec.index(DATA_AXIS), rows)

    return _zip_map(one, state, _specs(state))


def shard_serving(
    params,
    state: DecodeState,
    mesh: Mesh,
    mimi_params=None,
    mimi_state: Optional[MimiStreamState] = None,
    tensor_parallel: bool = False,
    shard_tables: bool = False,
    *,
    cfg=None,
):
    """Lay out everything for mesh serving.

    Returns this rank's (params, state, mimi_params, mimi_state): streams
    split over `data`; with tensor_parallel=True the LM backbone also split
    over `model` in the serving layout (`serving_partition_specs`; `cfg`
    gives the heads), otherwise the params and kv heads replicate over
    `model`. Mimi params always replicate (the vocoder is small)."""
    def to_device(a):
        return a if mesh.device is None else a.to(mesh.device)

    if tensor_parallel:
        if cfg is None:
            raise ValueError("shard_serving: tensor_parallel needs the model's cfg")
        params = shard_by_specs(params, serving_partition_specs(params, shard_tables), mesh, cfg)
    else:
        mesh = mesh.data_only()
        params = tree_map(to_device, params)
    state = shard_decode_state(state, mesh)
    if mimi_params is not None:
        mimi_params = tree_map(to_device, mimi_params)
    if mimi_state is not None:
        mimi_state = shard_mimi_state(mimi_state, mesh)
    return params, state, mimi_params, mimi_state
