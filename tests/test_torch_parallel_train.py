"""PyTorch port, training on a mesh (smoltts_torch/parallel/, train/) on gloo
ranks with device="cpu", against the JAX package and the port's own
one-process step:

- `make_global_batch`, `batch_sharding` and `param_shardings` give JAX's
  specs and slices; `unshard_params` inverts `shard_params` bit for bit;
- a DP x TP step on 2 x 2 at tests/test_training.py::test_sharded_train_step's
  config equals JAX's step on its 2 x 2 mesh (the tolerances of
  tests/test_torch_train_loop.py's trajectory test) and the one-process
  port step (rtol 2e-5, atol 2e-6, tests/test_multihost.py's), parameters
  and AdamW's moments put back together with `unshard_params`; the local
  leaves stay split;
- ragged valid-token counts on 2 x 1: JAX's global mean, not a mean of
  per-rank means;
- dropout 0.1 with remat on 2 x 1, 1 x 2, 2 x 2 and the counterpart of
  __graft_entry__.py::dryrun_multichip (1 x 2, tables split, accumulation 2)
  equal the one-process step: the masks do not depend on the mesh;
- the global norm over split leaves equals optax.global_norm;
- sequence parallelism: the forward on a replicated tree over 2 x 2 equals
  JAX's plain forward_train within 2e-5 (tests/test_training.py's SP test),
  on the dense route (T=32) and the blockwise one (T=512); SP + TP train
  steps equal the one-process step.

One spawn of ranks per world size (module fixtures); the JAX side runs in
this process."""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from smoltts_tpu.config import TrainingConfig as JaxTrainingConfig
from smoltts_tpu.config import tiny_debug_config as jax_tiny
from smoltts_tpu.models.dual_ar import forward_train as jax_forward_train
from smoltts_tpu.models.dual_ar import init_params as jax_init
from smoltts_tpu.parallel import mesh as jmesh
from smoltts_tpu.tokenizer import TokenConfig as JaxTokenConfig
from smoltts_tpu.train import trainer as jtrainer
from smoltts_tpu.train.data import collate, synthetic_dataset
from smoltts_torch.config import tiny_debug_config
from smoltts_torch.interop import params_from_jax_numpy
from smoltts_torch.models.dual_ar import forward_train, init_params
from smoltts_torch.parallel.launch import run_ranks
from smoltts_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    assemble_leaf,
    batch_sharding,
    make_global_batch,
    param_partition_specs,
    param_shardings,
    shard_params,
)
from smoltts_torch.train.loss import compute_losses
from smoltts_torch.train.optim import tree_leaves
from tests import torch_parallel_workers as W
from tests import torch_threads  # noqa: F401  (one intra-op thread)

SPAWN_TIMEOUT = 240.0
ONE = dict(rtol=2e-5, atol=2e-6)  # tests/test_multihost.py: a sharded run against one process
JAX_METRICS = dict(rtol=1e-4, atol=1e-4)  # tests/test_torch_train_loop.py's trajectory test
JAX_PARAMS = dict(rtol=3e-3, atol=3e-3)
SP_FWD = dict(rtol=2e-5, atol=2e-5)  # tests/test_training.py::test_sequence_parallel_forward
CB = 32
# tests/test_training.py::test_sharded_train_step's config
CFG = dict(codebook_size=CB, vocab_size=256 + 64 + CB, dim=64, n_head=4, n_local_heads=2,
           fast_dim=64, fast_n_head=4, fast_n_local_heads=2, dropout=0.0)
DROP = dict(CFG, dropout=0.1, use_gradient_checkpointing=True)
# __graft_entry__.py::dryrun_multichip's config
DRYRUN = dict(dim=128, n_head=4, n_local_heads=2, intermediate_size=256, fast_dim=128,
              fast_n_head=4, fast_n_local_heads=2, fast_intermediate_size=256, n_layer=2,
              n_fast_layer=2, codebook_size=64, vocab_size=256 + 64 + 64, dropout=0.1,
              use_gradient_checkpointing=True)
SP_CFG = dict(codebook_size=CB, vocab_size=256 + 64 + CB)  # tests/test_training.py's make_cfg
TC = dict(gradient_clip=1.0)
UNSHARD_TREES = {
    "f32": (dict(CFG, attention_qkv_bias=True, tie_word_embeddings=False), "float32", False),
    "bf16-tables": (dict(CFG, tie_word_embeddings=False), "bfloat16", True),
    "kv-shared-bf16": (dict(codebook_size=CB, vocab_size=352), "bfloat16", True),
}


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _batch(cfg_kw, B, T, seed):
    cfg = jax_tiny(**cfg_kw)
    rows = synthetic_dataset(B, cfg, JaxTokenConfig.smoltts_v0(cfg.codebook_size), seq_len=T,
                             seed=seed)
    return collate([r["ground_truth"] for r in rows],
                   JaxTokenConfig.smoltts_v0(cfg.codebook_size).pad_id, max_len=T)


def _ragged(batch):
    """Rows 0-1 (data rank 0 of 2) keep two valid labels each; rows 2-3 full."""
    labels = batch["labels"].copy()
    for r in (0, 1):
        keep = labels[r] != -100
        keep[:, 2:] = False
        labels[r][~keep] = -100
    return {**batch, "labels": labels}


@pytest.fixture(scope="module")
def weights():
    return {name: _np_tree(jax_init(jax_tiny(**kw), jax.random.PRNGKey(0)))
            for name, kw in (("tiny", CFG), ("dryrun", DRYRUN), ("sp", SP_CFG))}


def _cases2(w):
    b = _batch(CFG, 4, 32, 5)
    ragged = _ragged(_batch(CFG, 4, 24, 7))
    acc = {k: v.reshape(2, 2, *v.shape[1:]) for k, v in _batch(DRYRUN, 4, 32, 0).items()}
    cases = {
        "ragged": dict(kind="train", mesh=(2, 1), tc=TC, batches=[ragged], seeds=[1]),
        "dryrun": dict(kind="train", mesh=(1, 2), tc=dict(TC, accumulate_steps=2), cfg=DRYRUN,
                       weights=w["dryrun"], shard_tables=True, batches=[acc], seeds=[1]),
        "sp-tp-512": dict(kind="train", mesh=(1, 2), tc=TC, cfg=DROP, sp=True,
                          batches=[_batch(CFG, 1, 512, 9)], seeds=[5]),
        "norm": dict(kind="norm", mesh=(1, 2), seed=4, shard_tables=True),
        "unshard": dict(kind="unshard", mesh=(1, 2), trees=UNSHARD_TREES),
    }
    for mesh in ((2, 1), (1, 2)):
        cases[f"dropout-{mesh[0]}x{mesh[1]}"] = dict(kind="train", mesh=mesh, tc=TC, cfg=DROP,
                                                    batches=[b, b], seeds=[11, 12])
    return cases


def _cases4(w):
    b = _batch(CFG, 4, 32, 5)
    cases = {
        "dp-tp": dict(kind="train", mesh=(2, 2), tc=TC, batches=[_batch(CFG, 8, 24, 3)] * 2,
                      seeds=[1, 2]),
        "dropout-2x2": dict(kind="train", mesh=(2, 2), tc=TC, cfg=DROP, batches=[b], seeds=[11]),
        "sp-tp": dict(kind="train", mesh=(2, 2), tc=TC, cfg=DROP, sp=True, batches=[b, b],
                      seeds=[5, 6]),
        "unshard": dict(kind="unshard", mesh=(2, 2), trees=UNSHARD_TREES),
    }
    for T in (32, 512):  # the dense route and the blockwise one
        cases[f"sp-forward-{T}"] = dict(kind="forward", mesh=(2, 2), sp=True, cfg=SP_CFG,
                                        weights=w["sp"], tokens=_batch(SP_CFG, 2, T, 4)["tokens"])
    return cases


def _spawn(tmp_path_factory, w, n, cases):
    spec = dict(cfg=CFG, weights=w["tiny"], cases=cases)
    path = tmp_path_factory.mktemp(f"ranks{n}") / "spec.pkl"
    with open(path, "wb") as f:
        pickle.dump(spec, f)
    return spec, run_ranks(W.train_rank, n, str(path), timeout=SPAWN_TIMEOUT, device="cpu",
                           threads=1)


@pytest.fixture(scope="module")
def two(tmp_path_factory, weights):
    return _spawn(tmp_path_factory, weights, 2, _cases2(weights))


@pytest.fixture(scope="module")
def four(tmp_path_factory, weights):
    return _spawn(tmp_path_factory, weights, 4, _cases4(weights))


def _close(got, want, tol, what):
    for a, b in zip(tree_leaves(got), tree_leaves(want), strict=True):
        np.testing.assert_allclose(a, b, err_msg=what, **tol)


def _equals_one_process(spec, outs, name):
    """The rank (0, 0)'s metrics, whole parameters and moments against the
    one-process port step on the same global batches."""
    case = spec["cases"][name]
    ref = W.one_process_train(spec, case)
    got = next(o[name] for o in outs if o[name]["coords"] == (0, 0))
    for o in outs:  # every rank logs the global metrics
        for a, b in zip(o[name]["metrics"], ref["metrics"], strict=True):
            for k in b:
                np.testing.assert_allclose(a[k], b[k], err_msg=f"{name} {k}", **ONE)
    _close(got["params"], ref["params"], ONE, f"{name} params")
    for k in ("mu", "nu"):
        _close(got["moments"][k], ref["moments"][k], ONE, f"{name} {k}")
    return got, ref


# ---- specs and helpers ------------------------------------------------------


@pytest.mark.parametrize("accumulate", [1, 2])
def test_batch_specs_and_slices_equal_jax(accumulate):
    mesh = jmesh.make_mesh(2, 2, devices=jax.devices()[:4])
    spec = P(None, "data") if accumulate > 1 else P("data")  # JAX main.py's choice
    assert batch_sharding(None, accumulate) == tuple(spec)
    assert jmesh.batch_sharding(mesh).spec == P(*batch_sharding(None))
    b = _batch(CFG, 4 * accumulate, 16, 2)
    b = {k: v.reshape(accumulate, 4, *v.shape[1:]) if accumulate > 1 else v for k, v in b.items()}
    axis = batch_sharding(None, accumulate).index(DATA_AXIS)
    for k, v in b.items():
        arr = jax.device_put(v, NamedSharding(mesh, spec))
        for d in range(2):
            for m in range(2):
                dev = mesh.devices[d, m]
                want = next(s.data for s in arr.addressable_shards if s.device == dev)
                got = make_global_batch({k: v}, Mesh(2, 2, d, m, device="cpu"), axis)[k]
                assert got.device.type == "cpu"
                np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError, match="does not split over 2 ranks"):
        make_global_batch({"tokens": np.zeros((3, 2))}, Mesh(2, 1, 0, 0, device="cpu"))


@pytest.mark.parametrize("shard_tables", [False, True])
def test_param_shardings_equal_jax(shard_tables):
    mesh = jmesh.make_mesh(2, 2, devices=jax.devices()[:4])
    jparams = jax_init(jax_tiny(**dict(CFG, tie_word_embeddings=False)), jax.random.PRNGKey(0))
    want = jax.tree.map(lambda s: tuple(s.spec), jmesh.param_shardings(mesh, jparams, shard_tables),
                        is_leaf=lambda x: isinstance(x, NamedSharding))
    got = param_shardings(Mesh(2, 2), params_from_jax_numpy(_np_tree(jparams)), shard_tables)
    assert got == want


@pytest.mark.parametrize("tree", sorted(UNSHARD_TREES))
def test_assemble_leaf_inverts_each_coordinate_slice(tree):
    """Without ranks: the package's assemble_leaf over the slices shard_params
    cuts at each coordinate of a model axis of 2 gives each split leaf back."""
    cfg_kw, dtype, tables = UNSHARD_TREES[tree]
    cfg = tiny_debug_config(**cfg_kw)
    whole = init_params(cfg, torch.Generator().manual_seed(3), dtype=getattr(torch, dtype),
                        device="cpu")
    specs = param_partition_specs(whole, tables)
    parts = [shard_params(whole, Mesh(1, 2, 0, m), tables, cfg=cfg) for m in range(2)]
    heads = {"layers": (cfg.n_head, cfg.n_local_heads, cfg.head_dim),
             "fast_layers": (cfg.fast_n_head, cfg.fast_n_local_heads, cfg.fast_head_dim)}

    def walk(w, s, ps, name, trunk):
        if isinstance(s, dict):
            return sum(walk(w[k], s[k], [p[k] for p in ps], k, trunk) for k in s)
        if MODEL_AXIS not in s:
            return 0
        assert torch.equal(assemble_leaf(name, s, ps, heads.get(trunk)), w), name
        return 1

    assert sum(walk(whole[k], specs[k], [p[k] for p in parts], k, k) for k in specs) >= 10


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("tree", sorted(UNSHARD_TREES))
def test_unshard_params_inverts_shard_params(two, four, world, tree):
    """On 1 x 2 and 2 x 2: f32 and bf16 trees, with and without split
    tables, and a model axis wider than the kv heads (tiny: 2 query heads
    over 1 kv head): every leaf back bit for bit, in its dtype."""
    outs = (two if world == 2 else four)[1]
    for o in outs:
        smaller, bad = o["unshard"][tree]
        assert bad == [] and smaller >= 10, (tree, smaller, bad)


# ---- steps against JAX and against one process -------------------------------


def test_dp_tp_step_matches_jax_and_one_process(four, weights):
    spec, outs = four
    case = spec["cases"]["dp-tp"]
    got, ref = _equals_one_process(spec, outs, "dp-tp")
    # the leaves stay split: a rank's wqkv is its heads' columns
    cfg = tiny_debug_config(**CFG)
    whole = (cfg.n_head + 2 * cfg.n_local_heads) * cfg.head_dim
    assert all(o["dp-tp"]["local_wqkv"] == (cfg.n_layer, cfg.dim, whole // 2) for o in outs)
    fast = (cfg.fast_n_head + 2 * cfg.fast_n_local_heads) * cfg.fast_head_dim
    assert all(o["dp-tp"]["local_fast_wqkv"] == (cfg.n_fast_layer, cfg.fast_dim, fast // 2)
               for o in outs)  # the fast trunk splits too, as JAX's specs split it
    # JAX's step on its own 2 x 2 mesh
    jmesh_ = jmesh.make_mesh(2, 2, devices=jax.devices()[:4])
    jp = jax.tree.map(jax.device_put, weights["tiny"],
                      jmesh.param_shardings(jmesh_, weights["tiny"]))
    jtc = JaxTrainingConfig(**TC)
    jstate, jtx = jtrainer.init_train_state(jp, jtc)
    jstep = jtrainer.make_train_step(jax_tiny(**CFG), jtc, jtx, donate=False)
    bsh = NamedSharding(jmesh_, P("data"))
    for i, b in enumerate(case["batches"]):
        jstate, jm = jstep(jstate, {k: jax.device_put(jnp.asarray(v), bsh) for k, v in b.items()},
                           jax.random.PRNGKey(i))
        for k in ("loss", "base_loss", "semantic_loss", "grad_norm"):
            np.testing.assert_allclose(got["metrics"][i][k], float(jm[k]), err_msg=k,
                                       **JAX_METRICS)
    assert "model" in str(jstate.params["layers"]["wqkv"].sharding.spec)
    _close(got["params"], _np_tree(jstate.params), JAX_PARAMS, "params vs JAX")


def test_ragged_dp_step_is_the_global_mean(two, weights):
    """Rank 0's rows hold 2 valid labels each, rank 1's are full: the loss
    is one masked mean over the global batch, as JAX's, which an average of
    the two ranks' means misses by far more than the tolerance."""
    spec, outs = two
    case = spec["cases"]["ragged"]
    got, _ = _equals_one_process(spec, outs, "ragged")
    jtc = JaxTrainingConfig(**TC)
    jstate, jtx = jtrainer.init_train_state(weights["tiny"], jtc)
    jstep = jtrainer.make_train_step(jax_tiny(**CFG), jtc, jtx, donate=False)
    b = case["batches"][0]
    jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()}, jax.random.PRNGKey(0))
    for k in ("loss", "base_loss", "semantic_loss", "grad_norm"):
        np.testing.assert_allclose(got["metrics"][0][k], float(jm[k]), err_msg=k, **JAX_METRICS)
    _close(got["params"], _np_tree(jstate.params), JAX_PARAMS, "params vs JAX")

    params, cfg = params_from_jax_numpy(weights["tiny"]), tiny_debug_config(**CFG)
    with torch.no_grad():
        halves = []
        for rows in (slice(0, 2), slice(2, 4)):
            t = {k: torch.from_numpy(v[rows]) for k, v in b.items()}
            out = forward_train(params, cfg, t["tokens"])
            halves.append(float(compute_losses(out.token_logits, out.codebook_logits,
                                               t["labels"]).total))
    valid = [(b["labels"][rows] != -100).sum() for rows in (slice(0, 2), slice(2, 4))]
    assert valid[1] > 5 * valid[0], valid
    assert abs(np.mean(halves) - float(jm["loss"])) > 100 * JAX_METRICS["atol"], halves


@pytest.mark.parametrize("name", ["dropout-2x1", "dropout-1x2", "dryrun"])
def test_dropout_remat_step_matches_one_process(two, name):
    """Dropout 0.1 with remat: a sharded step equals the one-process step,
    so a rank's masks are its window on the global draw. `dryrun` is
    __graft_entry__.py::dryrun_multichip's step on 1 x 2 (tables split,
    accumulation 2)."""
    spec, outs = two
    got, _ = _equals_one_process(spec, outs, name)
    case = spec["cases"][name]
    calm = dict(case, cfg=dict(case["cfg"], dropout=0.0))
    assert W.one_process_train(spec, calm)["metrics"][0]["loss"] != got["metrics"][0]["loss"]


def test_dropout_remat_step_matches_one_process_on_2x2(four):
    _equals_one_process(*four, "dropout-2x2")


def test_global_norm_over_model_ranks_equals_optax(two):
    """A split tree (tables too) on 2 model ranks: each rank's norm is
    optax.global_norm of the whole tree."""
    for o in two[1]:
        want = float(optax.global_norm(jax.tree.map(jnp.asarray, o["norm"]["grads"])))
        np.testing.assert_allclose(o["norm"]["norm"], want, rtol=1e-6)


# ---- sequence parallelism ---------------------------------------------------


@pytest.mark.parametrize("T", [32, 512])
def test_sequence_parallel_forward_matches_jax(four, weights, T):
    """tests/test_training.py::test_sequence_parallel_forward: a replicated
    tree, the residual stream split over 'model' on T, over 2 x 2; T=32
    takes the dense attention, T=512 the blockwise one on every rank."""
    spec, outs = four
    case = spec["cases"][f"sp-forward-{T}"]
    ref = jax_forward_train(weights["sp"], jax_tiny(**SP_CFG), jnp.asarray(case["tokens"]))
    rows = {}
    for o in outs:
        d, m = o[f"sp-forward-{T}"]["coords"]
        rows.setdefault(d, {})[m] = o[f"sp-forward-{T}"]
    for f in ("token_logits", "codebook_logits"):
        for d in rows:  # model ranks hold the same rows
            np.testing.assert_array_equal(rows[d][0][f], rows[d][1][f])
        got = np.concatenate([rows[d][0][f] for d in sorted(rows)])
        np.testing.assert_allclose(got, np.asarray(getattr(ref, f)), err_msg=f, **SP_FWD)


@pytest.mark.parametrize("name,world", [("sp-tp", 4), ("sp-tp-512", 2)])
def test_sequence_and_tensor_parallel_step_matches_one_process(two, four, name, world):
    """SP + TP (Megatron sequence parallelism) with dropout 0.1 and remat,
    on 2 x 2 at T=32 and on 1 x 2 at T=512 (the blockwise route, each rank
    a 256-row share): equal to the one-process step."""
    _equals_one_process(*(two if world == 2 else four), name)
