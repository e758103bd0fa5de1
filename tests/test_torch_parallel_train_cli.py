"""PyTorch port, the training CLI on a mesh (tests/test_multihost.py:72-113):
`train.main.main --multihost` on two gloo ranks (device="cpu"), as 2 x 1
and 1 x 2 meshes, over a small saved dataset:

- its per-step losses, gradient norms and validation losses equal one
  process's run of the same config within rtol 2e-5 / atol 2e-6;
- the checkpoint it writes from the shards restores in one process
  (`CheckpointManager.load`) to the one-process run's parameters and
  moments within the same tolerance;
- auto-resume on the mesh takes up from that step, as one process does;
- it refuses what JAX refuses: a mesh whose product is not the world size
  (JAX's make_mesh message) and a batch that does not split over the data
  ranks.

The ranks' bodies are tests/torch_parallel_workers.py::cli_rank."""

import json

import jax
import numpy as np
import pytest
import torch

from smoltts_tpu.parallel.mesh import make_mesh as jax_make_mesh
from smoltts_torch.config import TrainingConfig, tiny_debug_config
from smoltts_torch.io.checkpoint import save_params
from smoltts_torch.models.dual_ar import init_params
from smoltts_torch.parallel.launch import run_ranks
from smoltts_torch.tokenizer import TokenConfig, save_byte_level_tokenizer
from smoltts_torch.train import main as train_main
from smoltts_torch.train.checkpoint import CheckpointManager
from smoltts_torch.train.data import synthetic_dataset
from smoltts_torch.train.optim import tree_leaves
from tests import torch_parallel_workers as W
from tests import torch_threads  # noqa: F401  (one intra-op thread)

ONE = dict(rtol=2e-5, atol=2e-6)  # tests/test_multihost.py
CB = 32
KW = dict(codebook_size=CB, vocab_size=256 + 64 + CB, dim=64, n_head=4, n_local_heads=2,
          fast_dim=64, fast_n_head=4, fast_n_local_heads=2)
HPARAMS = dict(learning_rate=1e-3, lr_start=1e-4, lr_warmup_steps=10, weight_decay=0.01,
               betas=(0.9, 0.95), eps=1e-8, gradient_clip=1.0)
MESHES = {"dp": (2, 1), "tp": (1, 2)}


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    """An init folder, a DatasetDict with train and val splits, and one run
    config per mesh (each its own checkpoint dir)."""
    from datasets import Dataset, DatasetDict

    d = tmp_path_factory.mktemp("cli")
    cfg = tiny_debug_config(**KW)
    save_byte_level_tokenizer(d / "init", CB)
    save_params(init_params(cfg, torch.Generator().manual_seed(0), device="cpu"), cfg, d / "init")
    # 10 validation rows: two whole windows of 4 on every data rank, as in one process
    rows = synthetic_dataset(42, cfg, TokenConfig.smoltts_v0(CB), seq_len=24, seed=0)
    as_ds = lambda rs: Dataset.from_dict({"ground_truth": [r["ground_truth"].tolist() for r in rs]})
    DatasetDict({"train": as_ds(rows[:32]), "val": as_ds(rows[32:])}).save_to_disk(str(d / "ds"))
    base = dict(HPARAMS, init_folder=str(d / "init"), dataset_path=str(d / "ds"), batch_size=4,
                max_epochs=3, max_sequence_length=24, use_bf16=False, use_pretrained=True,
                save_every_n_steps=2, val_every_n_steps=2, log_every_n_steps=1,
                keep_last_n_checkpoints=2, auto_resume=True)
    configs = {"one": dict(base, checkpoint_path=str(d / "ckpt_one"))}
    for name, (nd, nm) in MESHES.items():
        configs[name] = dict(base, checkpoint_path=str(d / f"ckpt_{name}"), mesh_data_axis=nd,
                             mesh_model_axis=nm)
    configs["odd-batch"] = dict(configs["dp"], batch_size=3)
    configs["3x1"] = dict(configs["dp"], mesh_data_axis=3)
    for name, c in configs.items():
        (d / f"{name}.json").write_text(json.dumps(c))
    return d


def _argv(d, name, steps, *extra):
    return ["--config", str(d / f"{name}.json"), "--device", "cpu", "--max-steps", str(steps),
            *extra]


@pytest.fixture(scope="module")
def one_process(run_dir):
    """The same runs in this process, no mesh: 2 steps, then 2 resumed."""
    logged = []
    real = train_main.default_log_fn
    train_main.default_log_fn = lambda use_wandb: (lambda step, m: logged.append((step, m)))
    try:
        for _ in range(2):
            train_main.main(_argv(run_dir, "one", 2))
    finally:
        train_main.default_log_fn = real
    return logged


@pytest.fixture(scope="module")
def ranks(run_dir):
    runs = []
    for name in MESHES:  # 2 steps, then an auto-resumed 2
        runs += [(_argv(run_dir, name, 2, "--multihost"), False)] * 2
    runs += [(_argv(run_dir, "odd-batch", 1, "--multihost"), True),
             (_argv(run_dir, "3x1", 1, "--multihost"), True)]
    return run_ranks(W.cli_rank, 2, runs, timeout=240.0, device="cpu", threads=1)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_cli_losses_match_one_process(one_process, ranks, mesh):
    i = list(MESHES).index(mesh) * 2
    first, resumed = ranks[0][i], ranks[0][i + 1]
    assert first[:2] == ("ok", 2) and resumed[:2] == ("ok", 4)
    assert all(r[i][:2] == first[:2] and r[i + 1][:2] == resumed[:2] for r in ranks)
    got = first[2] + resumed[2]
    assert [s for s, _ in got] == [s for s, _ in one_process] == [1, 2, 2, 3, 4, 4]
    for (s, m), (_, ref) in zip(got, one_process):
        assert m.keys() == ref.keys()
        for k in ref:
            if k != "steps_per_s":
                np.testing.assert_allclose(m[k], ref[k], err_msg=f"step {s} {k}", **ONE)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_checkpoint_from_shards_restores_in_one_process(one_process, ranks, run_dir, mesh):
    """Rank 0 wrote the whole trees at steps 2 and 4 (the resumed run's);
    one process loads them, equal to its own run's checkpoints."""
    tc = TrainingConfig.from_dict(json.loads((run_dir / "one.json").read_text()))
    for step in (2, 4):
        (mine,) = (run_dir / f"ckpt_{mesh}").glob(f"*/step_{step:06d}")
        (ref,) = (run_dir / "ckpt_one").glob(f"*/step_{step:06d}")
        got, n, reinit = CheckpointManager.load(str(mine), tc)
        want, _, _ = CheckpointManager.load(str(ref), tc)
        assert n == step and not reinit
        for a, b in zip(tree_leaves(got["params"]), tree_leaves(want["params"]), strict=True):
            assert a.shape == b.shape
            np.testing.assert_allclose(a.numpy(), b.numpy(), **ONE)
        sg, sw = got["opt_state"], want["opt_state"]
        assert sg["param_groups"][0]["count"] == sw["param_groups"][0]["count"] == step
        for i in sw["state"]:
            for k in ("mu", "nu"):
                assert sg["state"][i][k].dtype == sw["state"][i][k].dtype == torch.float32
                np.testing.assert_allclose(sg["state"][i][k].numpy(),
                                           sw["state"][i][k].numpy(), **ONE)
    # rank 1 made no run dir of its own: each holds checkpoints
    assert all(any(r.glob("step_*")) for r in (run_dir / f"ckpt_{mesh}").iterdir())


def test_cli_refuses_what_jax_refuses(ranks):
    with pytest.raises(AssertionError) as jax_err:
        jax_make_mesh(3, 1, devices=jax.devices()[:2])
    for r in ranks:
        assert r[-2] == ("error", "batch_size 3 does not split over 2 data ranks")
        assert r[-1] == ("error", str(jax_err.value)) == ("error", "mesh 3x1 != 2 devices")


@pytest.mark.parametrize("rows,acc", [(8, 1), (12, 1), (16, 2)])
def test_rank_batches_step_one_global_window(rows, acc):
    """JAX's batch_iterator gives process 1 of 2 a window fewer an epoch
    when the last window is full; `rank_batches` keeps, on both data ranks,
    the windows both have, and each step's two halves hold one window of the
    one-process run (under accumulation in another micro-batch order, as
    JAX's multi-process batches)."""
    from smoltts_tpu.train.data import batch_iterator as jax_batch_iterator
    from smoltts_torch.parallel.mesh import Mesh
    from smoltts_torch.train.main import rank_batches

    ds = [{"ground_truth": np.full((9, 5), i, np.int32)} for i in range(rows)]
    kw = dict(semantic_pad_id=0, max_len=4, epochs=2, seed=1)
    jax_counts = [len(list(jax_batch_iterator(ds, 2, accumulate_steps=acc, process_index=p,
                                              process_count=2, **kw))) for p in range(2)]
    ranks = [[b["tokens"] for b in rank_batches(ds, Mesh(2, 1, p, 0), 2, acc, **kw)]
             for p in range(2)]
    assert len(ranks[0]) == len(ranks[1]) == min(jax_counts) > 0
    whole = [b["tokens"] for b in rank_batches(ds, None, 4, acc, **kw)]
    ids = lambda t: sorted(t[..., 0, 0].ravel().tolist())
    for a, b in zip(*ranks):
        merged = np.concatenate([a, b], 1 if acc > 1 else 0)
        assert any((np.array_equal(merged, w) if acc == 1 else ids(merged) == ids(w))
                   for w in whole)
    if rows == 8:
        assert jax_counts == [4, 2]
