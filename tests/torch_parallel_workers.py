"""Rank bodies for tests/test_torch_parallel_*.py, run by
`smoltts_torch.parallel.launch.run_ranks` on gloo with device="cpu".

This module imports the port alone (no JAX, nothing of the JAX package), so
the spawned ranks never load JAX; each body checks that on its way out. The
parent test runs the JAX side and passes the weights as numpy trees in a
pickle file."""

import pickle
import sys

import numpy as np
import torch

from smoltts_torch.codec.config import MimiConfig
from smoltts_torch.codec.mimi import decode_stream_init
from smoltts_torch.config import ModelType, TrainingConfig, tiny_debug_config
from smoltts_torch.interop import params_from_jax_numpy, tree_map
from smoltts_torch.lm.decode import decode_frame, init_decode_state, prefill
from smoltts_torch.lm.pipeline import make_prefill_step, make_stream_step
from smoltts_torch.lm.samplers import GenerationSettings
from smoltts_torch.models.dual_ar import forward_train, init_params
from smoltts_torch.parallel.mesh import (
    DATA_AXIS,
    SEQUENCE_SHARDING,
    batch_sharding,
    make_global_batch,
    make_mesh,
    shard_params,
    unshard_params,
)
from smoltts_torch.parallel.serving import shard_serving
from smoltts_torch.tokenizer import ByteTokenizer, TokenConfig
from smoltts_torch.train.optim import global_norm, split_leaves, tree_leaves, tree_unflatten
from smoltts_torch.train.trainer import init_train_state, make_train_step

CB = 32
# tests/test_parallel_serving.py::_setup's codec
MIMI = dict(num_filters=8, hidden_size=32, num_hidden_layers=1, num_attention_heads=2,
            head_dim=16, intermediate_size=64, num_quantizers=8, codebook_size=CB,
            codebook_dim=16, sliding_window=16, upsample_groups=32)
GREEDY = dict(default_temp=0.0, default_fast_temp=0.0)


def _no_jax() -> None:
    bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "smoltts_tpu")]
    assert not bad, f"a rank imported {bad[:5]}"


def _load(path):
    with open(path, "rb") as f:
        return {k: params_from_jax_numpy(v) for k, v in pickle.load(f).items()}


def tiny_setup(settings=GREEDY):
    cfg = tiny_debug_config(codebook_size=CB, vocab_size=256 + 64 + CB)
    tok = TokenConfig.from_tokenizer(ModelType.smoltts_v0(), ByteTokenizer(CB), cfg)
    return cfg, tok, GenerationSettings(**settings), MimiConfig(**MIMI)


def serving_prompt(cfg, tok, B=8, T=6):
    """test_parallel_serving.py::_run's prompt."""
    rng = np.random.default_rng(0)
    prompt = np.zeros((B, cfg.num_rows, T), np.int32)
    prompt[:, 0] = tok.semantic_start_id + rng.integers(0, CB, (B, T))
    prompt[:, 1:] = rng.integers(0, CB, (B, cfg.num_rows - 1, T))
    return prompt


def pipeline_rank(rank, n_data, n_model, tp, weights, settings=GREEDY):
    """test_parallel_serving.py::_run on this rank's part of the mesh:
    prefill + 3 stream steps, B=8, T=6, S=64, tails of 8. Returns the
    rank's coordinates, codes [4, B/n_data, ncb], PCM and slow tokens."""
    cfg, tok, gs, mcfg = tiny_setup(settings)
    trees = _load(weights)
    mesh = make_mesh(n_data, n_model, device="cpu")
    B, T, S = 8, 6, 64
    state = init_decode_state(cfg, B, S, dtype=torch.float32, tail_len=8, device="cpu")
    mstate = decode_stream_init(mcfg, B, dtype=torch.float32, tail_len=8, device="cpu")
    p, state, mp, mstate = shard_serving(trees["lm"], state, mesh, mimi_params=trees["mimi"],
                                         mimi_state=mstate, tensor_parallel=tp, cfg=cfg)
    step_mesh = mesh if tp else mesh.data_only()
    b0 = mesh.data * (B // n_data)
    prompt = torch.from_numpy(serving_prompt(cfg, tok)[b0 : b0 + B // n_data])
    prefill_step = make_prefill_step(cfg, tok, gs, mcfg, device="cpu", mesh=step_mesh)
    stream_step = make_stream_step(cfg, tok, gs, mcfg, device="cpu", mesh=step_mesh)
    gen = torch.Generator().manual_seed(1 + mesh.data)  # model ranks alike, data ranks apart
    state, mstate, gen, out = prefill_step(p, mp, state, mstate, prompt,
                                           torch.full((prompt.shape[0],), T, dtype=torch.int32),
                                           gen)
    frames, pcms, slow = [out.audio_codes.numpy()], [out.pcm.numpy()], [out.slow_token.numpy()]
    for _ in range(3):
        state, mstate, gen, out = stream_step(p, mp, state, mstate, gen)
        frames.append(out.audio_codes.numpy())
        pcms.append(out.pcm.numpy())
        slow.append(out.slow_token.numpy())
    _no_jax()
    return dict(coords=(mesh.data, mesh.model), frames=np.stack(frames),
                pcm=np.concatenate(pcms, axis=1), slow=np.stack(slow),
                kv_heads=state.k.shape[2], slots=state.k.shape[1])


def backbone_rank(rank, n_model, weights, prompt, preset, cfg_kw):
    """test_tp_scale.py::test_backbone_sharded_150m_decode_matches_replicated
    on a (1, n_model) mesh, tables split: prefill + 2 frames -> tokens, and
    the local widths of the split tables."""
    from smoltts_torch import config

    cfg = getattr(config, preset)().replace(**cfg_kw)
    tok = TokenConfig.smoltts_v0()
    gs = GenerationSettings(**GREEDY)
    mesh = make_mesh(1, n_model, device="cpu")
    B, T, S = prompt.shape[0], prompt.shape[2], 64
    state = init_decode_state(cfg, B, S, dtype=torch.float32, tail_len=8, device="cpu")
    p, state, _, _ = shard_serving(_load(weights)["lm"], state, mesh, tensor_parallel=True,
                                   shard_tables=True, cfg=cfg)
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        state, out = prefill(p, cfg, tok, gs, state, torch.from_numpy(prompt),
                             torch.full((B,), T, dtype=torch.int32), gen, mesh=mesh)
        frames = [out.tokens.numpy()]
        for _ in range(2):
            state, out = decode_frame(p, cfg, tok, gs, state, gen, mesh=mesh)
            frames.append(out.tokens.numpy())
    _no_jax()
    widths = {k: tuple(p[k].shape) for k in ("codebook_embeddings", "output") if k in p}
    return dict(frames=np.stack(frames), widths=widths, w1=p["layers"]["w1"].shape[-1])


def engine_prompt(cfg, tok, T, seed):
    """test_parallel_serving.py::_run_engine's prompt_of."""
    r = np.random.default_rng(seed)
    p = np.zeros((cfg.num_rows, T), np.int32)
    p[0] = tok.semantic_start_id + r.integers(0, CB, T)
    p[1:] = r.integers(0, CB, (cfg.num_rows - 1, T))
    return p


BUDGETS = [12, 5, 9, 7, 6, 4]


def _engine(cfg, tok, gs, mcfg, trees):
    from smoltts_torch.lm.engine import DecodeEngine

    return DecodeEngine(
        trees["lm"], cfg, tok, gs, num_slots=4, max_seq_len=64, kv_dtype=torch.float32,
        prompt_bucket=8, mimi_params=trees["mimi"], mimi_cfg=mcfg, attend_buckets=[16, 64],
        chunk_frames=2, tail_len=8, inflight=1, fetch_every=1, device="cpu")


def engine_rank(rank, n_data, n_model, tp, weights, loop=False):
    """test_parallel_serving.py::_run_engine on a sharded engine: rank 0
    leads (the episode, or the same streams through an EngineLoop), the
    others follow. Returns {stream: (codes [F, ncb], PCM)} from the leader."""
    import queue

    from smoltts_torch.lm.engine import EngineLoop

    cfg, tok, gs, mcfg = tiny_setup()
    mesh = make_mesh(n_data, n_model, device="cpu")
    eng = _engine(cfg, tok, gs, mcfg, _load(weights)).shard(mesh, tensor_parallel=tp)
    if not eng.is_leader:
        eng.follow()
        _no_jax()
        return None
    collected = {}
    try:
        eng.warm(buckets=[16])  # runs on every rank; leaves the engine's state alone
        if loop:
            lp = EngineLoop(eng, fetchers=2)
            qs = [lp.submit(engine_prompt(cfg, tok, 6, 10 + i), max_frames=b)
                  for i, b in enumerate(BUDGETS)]
            try:
                for i, q in enumerate(qs):
                    while (f := q.get(timeout=120)) is not None:
                        collected.setdefault(i, []).append(f)
            except queue.Empty:
                raise AssertionError(f"stream {i} stalled") from None
            finally:
                lp.stop()
        else:
            sids = [eng.submit(engine_prompt(cfg, tok, 6, 10 + i), max_frames=b)
                    for i, b in enumerate(BUDGETS[:5])]
            steps, late = 0, False
            while eng.has_work() or not late:
                if steps == 4 and not late:
                    sids.append(eng.submit(engine_prompt(cfg, tok, 6, 15), max_frames=BUDGETS[5]))
                    late = True
                for sid, frame in eng.step():
                    collected.setdefault(sids.index(sid), []).append(frame)
                steps += 1
                assert steps < 200, "engine did not drain"
    finally:
        eng.release_followers()
    _no_jax()
    return {i: (np.stack([f["audio_codes"] for f in fs]), np.concatenate([f["pcm"] for f in fs]))
            for i, fs in collected.items()}


def mesh_rank(rank):
    """On 4 ranks: the meshes JAX refuses, the host-aware layout, and the
    collectives on a 2 x 2 mesh. Returns what each produced (numpy), for the
    parent to hold every rank to the same bits."""
    import os

    from smoltts_torch.parallel.collectives import gather_model
    from smoltts_torch.parallel.mesh import make_multihost_mesh

    refusals = {}
    for name, call in (("3x1", lambda: make_mesh(3, 1, device="cpu")),
                       ("-1x3", lambda: make_mesh(-1, 3, device="cpu"))):
        try:
            call()
        except ValueError as e:
            refusals[name] = str(e)
    os.environ["LOCAL_WORLD_SIZE"] = "2"  # two hosts of two ranks
    try:
        make_multihost_mesh(4, device="cpu")
    except ValueError as e:
        refusals["multihost 4"] = str(e)
    mesh = make_multihost_mesh(2, device="cpu")
    d, m = mesh.data, mesh.model
    g = torch.Generator().manual_seed(rank)
    x32 = torch.randn((3, 5), generator=g)
    x32[0, 0] = -0.0
    x32[1, 1] = float("nan")
    parts = [x32, torch.rand((3,), generator=g) > 0.5,
             torch.randint(-9, 9, (3, 2), generator=g, dtype=torch.int32),
             torch.randn((3, 7), generator=g).to(torch.bfloat16), None,
             # trailing size-1 axis with a stride other than 1 (a PCM [B, n, 1])
             torch.randn((3, 1, 4), generator=g).transpose(1, 2)]
    data_gathered = mesh.data_gather(parts, 0)
    chunk = mesh.data_gather([torch.randn((2, 3, 4), generator=g)], 1)[0]
    summed = mesh.model_sum(torch.full((4,), float(rank + 1)) / 3)
    logits = gather_model(torch.arange(6, dtype=torch.float32).reshape(2, 3) + 10 * m, mesh, -1)
    plan = mesh.broadcast_object({"rank": rank, "arr": np.arange(rank + 3)} if rank == 0 else None)
    _no_jax()
    as_np = lambda t: t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()
    return dict(coords=(d, m), refusals=refusals, parts=[None if p is None else as_np(p) for p in parts],
                data_gathered=[None if t is None else as_np(t) for t in data_gathered],
                chunk=chunk.numpy(), summed=summed.numpy(), logits=logits.numpy(), plan=plan)


# ---- training on a mesh (tests/test_torch_parallel_train.py) ---------------


def _np(t):
    """A tensor as numpy; bf16 widened to f32 exactly."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _np_tree(tree):
    return tree_map(_np, tree)


def _case_setup(spec, case):
    """The case's config (its own or the spec's), whole f32 tree and
    TrainingConfig."""
    cfg = tiny_debug_config(**case.get("cfg", spec["cfg"]))
    params = params_from_jax_numpy(case.get("weights", spec["weights"]))
    return cfg, params, TrainingConfig(**case.get("tc", {}))


def _steps(cfg, tc, state, tx, case, mesh=None):
    """Run the case's steps; (state, metrics per step)."""
    A = tc.accumulate_steps
    step = make_train_step(cfg, tc, tx, accumulate_steps=A, mesh=mesh,
                           activation_sharding=SEQUENCE_SHARDING if case.get("sp") else None)
    metrics = []
    for batch, seed in zip(case["batches"], case["seeds"]):
        if mesh is not None:
            batch = make_global_batch(batch, mesh, batch_sharding(mesh, A).index(DATA_AXIS))
        state, m = step(state, batch, seed)
        metrics.append({k: float(v) for k, v in m.items()})
    return state, metrics


def _moments_tree(tx, params):
    ps = tx.param_groups[0]["params"]
    return {k: tree_unflatten(params, [tx.state[p][k] for p in ps]) for k in ("mu", "nu")}


def one_process_train(spec, case):
    """The case's steps in this process on the whole tree: metrics per
    step, the updated parameters and AdamW's moments (numpy)."""
    cfg, params, tc = _case_setup(spec, case)
    state, tx = init_train_state(params, tc)
    state, metrics = _steps(cfg, tc, state, tx, case)
    return dict(metrics=metrics, params=_np_tree(state.params),
                moments=_np_tree(_moments_tree(tx, state.params)))


def _mesh_train(cfg, params, tc, case):
    mesh = make_mesh(*case["mesh"], device="cpu")
    tables = case.get("shard_tables", False)
    state, tx = init_train_state(shard_params(params, mesh, tables, cfg=cfg), tc, mesh=mesh,
                                 shard_tables=tables)
    state, metrics = _steps(cfg, tc, state, tx, case, mesh)
    moments = {k: unshard_params(t, mesh, cfg, tables)
               for k, t in _moments_tree(tx, state.params).items()}
    whole = unshard_params(state.params, mesh, cfg, tables)
    lead = (mesh.data, mesh.model) == (0, 0)
    return dict(coords=(mesh.data, mesh.model), metrics=metrics,
                local_wqkv=tuple(state.params["layers"]["wqkv"].shape),
                local_fast_wqkv=tuple(state.params["fast_layers"]["wqkv"].shape),
                params=_np_tree(whole) if lead else None,
                moments=_np_tree(moments) if lead else None)


def _mesh_forward(cfg, params, case):
    """forward_train on this rank's rows (a replicated or split tree, with
    or without sequence parallelism): the rank's logits."""
    mesh = make_mesh(*case["mesh"], device="cpu")
    if case.get("split"):
        params = shard_params(params, mesh, cfg=cfg)
    tokens = make_global_batch({"tokens": case["tokens"]}, mesh)["tokens"]
    with torch.no_grad():
        out = forward_train(params, cfg, tokens, mesh=mesh,
                            activation_sharding=SEQUENCE_SHARDING if case.get("sp") else None)
    return dict(coords=(mesh.data, mesh.model), token_logits=_np(out.token_logits),
                codebook_logits=_np(out.codebook_logits))


def _mesh_norm(cfg, params, case):
    """global_norm of a gradient-shaped tree split as the parameters."""
    mesh = make_mesh(*case["mesh"], device="cpu")
    g = torch.Generator().manual_seed(case["seed"])
    grads = tree_map(lambda t: torch.randn(t.shape, generator=g) * 1e-2, params)
    tables = case.get("shard_tables", False)
    local = shard_params(grads, mesh, tables, cfg=cfg)
    norm = global_norm(tree_leaves(local), mesh, split_leaves(local, mesh, tables))
    return dict(norm=float(norm), grads=_np_tree(grads))


def _mesh_unshard(cfg, params, case):
    """shard_params then unshard_params, for several trees: the names of the
    leaves that did not come back bit for bit (dtype included)."""
    mesh = make_mesh(*case["mesh"], device="cpu")
    bad = {}
    for label, (cfg_kw, dtype, tables) in case["trees"].items():
        c = tiny_debug_config(**cfg_kw)
        whole = init_params(c, torch.Generator().manual_seed(3), dtype=getattr(torch, dtype),
                            device="cpu")
        if "wqkv_bias" in whole["layers"]:
            bias = whole["layers"]["wqkv_bias"]
            whole["layers"]["wqkv_bias"] = torch.randn(
                bias.shape, generator=torch.Generator().manual_seed(4)).to(bias.dtype)
        local = shard_params(whole, mesh, tables, cfg=c)
        back = unshard_params(local, mesh, c, tables)
        smaller = sum(a.numel() < b.numel() for a, b in zip(tree_leaves(local),
                                                             tree_leaves(whole)))
        bad[label] = (smaller, [i for i, (a, b) in enumerate(zip(tree_leaves(back),
                                                                   tree_leaves(whole)))
                                if a.dtype != b.dtype or not torch.equal(a, b)])
    return bad


def train_rank(rank, spec_path):
    """The cases of a pickled spec on this rank, in order: "train" (steps
    on a mesh), "forward", "norm", "unshard". Each builds its own mesh over
    every rank."""
    with open(spec_path, "rb") as f:
        spec = pickle.load(f)
    out = {}
    for name, case in spec["cases"].items():
        cfg, params, tc = _case_setup(spec, case)
        kind = case["kind"]
        if kind == "train":
            out[name] = _mesh_train(cfg, params, tc, case)
        elif kind == "forward":
            out[name] = _mesh_forward(cfg, params, case)
        elif kind == "norm":
            out[name] = _mesh_norm(cfg, params, case)
        else:
            out[name] = _mesh_unshard(cfg, params, case)
    _no_jax()
    return out


def cli_rank(rank, runs):
    """train.main.main on this rank for each (argv, expect_error) in
    `runs`: the metrics it logged (rank 0), or the error it raised."""
    from smoltts_torch.train import main as train_main

    out = []
    for argv, expect_error in runs:
        logged = []
        train_main.default_log_fn = lambda use_wandb: (lambda step, m: logged.append((step, m)))
        try:
            state = train_main.main(argv)
        except ValueError as e:
            if not expect_error:
                raise
            out.append(("error", str(e)))
            continue
        out.append(("ok", state.step, logged if rank == 0 else None))
    _no_jax()
    return out
