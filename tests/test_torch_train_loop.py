"""PyTorch port, the trainer against the JAX package: data (collate,
batch_iterator, synthetic_dataset: equal arrays), the schedule and the decay
partition (equal), one AdamW update against optax (1e-6), a 20-step
`make_train_step` trajectory against JAX's with dropout 0 and with
accumulate 2 (losses 1e-4 early, 2e-3 at step 20, final params 3e-3, as
PARITY.md's trajectory test); and, in the port, CheckpointManager, `main` on a
tiny saved HF dataset with --device cpu, and `convert` (its safetensors equal
the JAX converter's bit for bit)."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from smoltts_tpu.config import TrainingConfig as JaxTrainingConfig
from smoltts_tpu.config import tiny_debug_config as jax_tiny
from smoltts_tpu.io import convert as jax_convert
from smoltts_tpu.models.dual_ar import init_params as jax_init
from smoltts_tpu.tokenizer import TokenConfig as JaxTokenConfig
from smoltts_tpu.train import data as jdata
from smoltts_tpu.train import optim as joptim
from smoltts_tpu.train import trainer as jtrainer
from smoltts_torch.config import TrainingConfig, load_training_config, tiny_debug_config
from smoltts_torch.interop import params_from_jax_numpy, tree_map
from smoltts_torch.io import checkpoint as tci
from smoltts_torch.io import convert as tconvert
from smoltts_torch.io.safetensors import load_file
from smoltts_torch.models.dual_ar import init_params
from smoltts_torch.tokenizer import TokenConfig, save_byte_level_tokenizer
from smoltts_torch.train import data as tdata
from smoltts_torch.train import optim as toptim
from smoltts_torch.train import trainer as ttrainer
from smoltts_torch.train.checkpoint import CheckpointManager
from tests import torch_threads  # noqa: F401  (one intra-op thread)

CB = 32
KW = dict(codebook_size=CB, vocab_size=256 + 64 + CB)
HPARAMS = dict(learning_rate=1e-3, lr_start=1e-4, lr_warmup_steps=10, weight_decay=0.01,
               betas=(0.9, 0.95), eps=1e-8, gradient_clip=1.0)


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads: the suite runs several workers on one host, and
    torch's default (one thread per core in every worker) oversubscribes it."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def to_torch(tree):
    return params_from_jax_numpy(jax.tree.map(np.asarray, tree))


def test_data_equals_jax():
    jcfg, cfg = jax_tiny(**KW), tiny_debug_config(**KW)
    jtok, tok = JaxTokenConfig.smoltts_v0(CB), TokenConfig.smoltts_v0(CB)
    assert tok.pad_id == jtok.pad_id and tok.semantic_start_id == jtok.semantic_start_id
    ref = jdata.synthetic_dataset(12, jcfg, jtok, seq_len=40, seed=3)
    got = tdata.synthetic_dataset(12, cfg, tok, seq_len=40, seed=3)
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(a["ground_truth"], b["ground_truth"])
    rows = [r["ground_truth"] for r in ref]
    for k, v in jdata.collate(rows, jtok.pad_id, 32).items():
        np.testing.assert_array_equal(tdata.collate(rows, tok.pad_id, 32)[k], v)
    for acc, pi, pc in [(1, 0, 1), (2, 0, 1), (1, 1, 2)]:
        kw = dict(batch_size=2, semantic_pad_id=tok.pad_id, max_len=48, accumulate_steps=acc,
                  seed=5, epochs=2, process_index=pi, process_count=pc)
        jb, tb = list(jdata.batch_iterator(ref, **kw)), list(tdata.batch_iterator(got, **kw))
        assert len(jb) == len(tb) > 0
        for a, b in zip(jb, tb):
            assert a.keys() == b.keys()
            for k in a:
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])


def test_schedule_and_decay_partition_equal_jax():
    tc, jtc = TrainingConfig(**HPARAMS), JaxTrainingConfig(**HPARAMS)
    ts, js = toptim.lr_schedule(tc), joptim.lr_schedule(jtc)
    for step in (0, 1, 3, 9, 10, 11, 1000):
        assert np.float32(ts(step)) == np.asarray(js(jnp.int32(step)), np.float32), step
    jparams = jax_init(jax_tiny(**KW, attention_qkv_bias=True, fast_dim=48),
                       jax.random.PRNGKey(0))
    assert "fast_project_in" in jparams and "wqkv_bias" in jparams["layers"]
    assert toptim.decay_mask(to_torch(jparams)) == joptim.decay_mask(jparams)
    assert toptim.decay_mask(to_torch(jparams))["embeddings"] is True
    # leaves in JAX's pytree order
    jl = jax.tree.leaves(jparams)
    tl = toptim.tree_leaves(to_torch(jparams))
    assert [a.shape for a in jl] == [tuple(b.shape) for b in tl]


@pytest.mark.parametrize("clip", [1e-3, 100.0, 0.0])
def test_adamw_updates_match_optax(clip):
    """Three updates on the same gradients (warmup, bias correction, decay
    on some leaves, clipping engaged at 1e-3, not at 100, off at 0)."""
    hp = dict(HPARAMS, gradient_clip=clip, lr_warmup_steps=2)
    rng = np.random.default_rng(0)
    jparams = {"w": jnp.asarray(rng.standard_normal((6, 5)), jnp.float32),
               "norm": jnp.asarray(rng.standard_normal((5,)), jnp.float32),
               "inner": {"bias": jnp.asarray(rng.standard_normal((3,)), jnp.float32),
                         "kernel": jnp.asarray(rng.standard_normal((4, 3)), jnp.float32)}}
    tx = joptim.create_optimizer(JaxTrainingConfig(**hp), jparams)
    jstate = tx.init(jparams)
    params = to_torch(jparams)
    opt = toptim.create_optimizer(TrainingConfig(**hp), params)
    for _ in range(3):
        grads = jax.tree.map(lambda p: jnp.asarray(rng.standard_normal(p.shape), jnp.float32) * 0.3,
                             jparams)
        upd, jstate = tx.update(grads, jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        norm = opt.step([torch.from_numpy(np.array(g)) for g in jax.tree.leaves(grads)])
        np.testing.assert_allclose(float(norm), float(optax.global_norm(grads)), rtol=1e-6)
        for a, b in zip(jax.tree.leaves(jparams), toptim.tree_leaves(params)):
            np.testing.assert_allclose(b.detach().numpy(), np.asarray(a), rtol=1e-6, atol=1e-6)
    assert opt.param_groups[0]["count"] == 3


def make_batches(cfg, n, accumulate=1):
    tok = JaxTokenConfig.smoltts_v0(CB)
    ds = jdata.synthetic_dataset(64, cfg, tok, seq_len=40, seed=0)
    it = jdata.batch_iterator(ds, batch_size=4 // accumulate, semantic_pad_id=tok.pad_id,
                              max_len=48, accumulate_steps=accumulate, seed=1, epochs=100)
    return [next(it) for _ in range(n)]


@pytest.mark.parametrize("accumulate", [1, 2])
def test_train_step_trajectory_matches_jax(accumulate):
    """20 steps of make_train_step from the same init on the same batches,
    dropout 0 (the bits differ by contract)."""
    jcfg, cfg = jax_tiny(**KW), tiny_debug_config(**KW)
    steps = 20 if accumulate == 1 else 6
    batches = make_batches(jcfg, steps, accumulate)
    jparams = jax_init(jcfg, jax.random.PRNGKey(0))
    params = to_torch(jparams)
    jtc = JaxTrainingConfig(**HPARAMS, accumulate_steps=accumulate)
    jstate, jtx = jtrainer.init_train_state(jparams, jtc)
    jstep = jtrainer.make_train_step(jcfg, jtc, jtx, accumulate_steps=accumulate, donate=False)
    tc = TrainingConfig(**HPARAMS, accumulate_steps=accumulate)
    state, tx = ttrainer.init_train_state(params, tc)
    step = ttrainer.make_train_step(cfg, tc, tx, accumulate_steps=accumulate)
    for i, b in enumerate(batches):
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()},
                           jax.random.PRNGKey(i))
        state, m = step(state, b, i)
        for k in ("loss", "base_loss", "semantic_loss", "grad_norm"):
            tol = 1e-4 if i < 5 else 2e-3
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=tol, atol=tol,
                                       err_msg=f"step {i} {k}")
    assert state.step == steps and int(jstate.step) == steps
    for a, b in zip(jax.tree.leaves(jstate.params), toptim.tree_leaves(state.params)):
        np.testing.assert_allclose(b.detach().numpy(), np.asarray(a), rtol=3e-3, atol=3e-3)


def test_validate_and_loss_falls():
    cfg = tiny_debug_config(**KW, use_gradient_checkpointing=True, dropout=0.1)
    tok = TokenConfig.smoltts_v0(CB)
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    tc = TrainingConfig(batch_size=4, learning_rate=3e-3, lr_start=3e-3, lr_warmup_steps=1,
                        gradient_clip=1.0, weight_decay=0.01)
    state, tx = ttrainer.init_train_state(params, tc)
    step = ttrainer.make_train_step(cfg, tc, tx)
    ds = tdata.synthetic_dataset(8, cfg, tok, seq_len=32, seed=0)
    batch = tdata.collate([r["ground_truth"] for r in ds[:4]], tok.pad_id, max_len=32)
    losses = []
    for i in range(12):
        state, m = step(state, batch, 100 + i)
        losses.append(float(m["loss"]))
    assert np.isfinite(losses).all() and losses[-1] < losses[0] * 0.9, losses
    val = list(tdata.batch_iterator(ds, batch_size=2, semantic_pad_id=tok.pad_id, max_len=32))
    vm = ttrainer.validate(state.params, cfg, val)
    assert np.isfinite(vm["loss"]) and f"codebook_{cfg.max_fast_seqlen}_loss" in vm


def test_train_loop_logs_validates_and_profiles(tmp_path):
    """train_loop with accumulation 2: log, validation and checkpoint
    cadences, and a torch.profiler trace of steps [2, 3)."""
    cfg = tiny_debug_config(**KW)
    tc = TrainingConfig(**HPARAMS, accumulate_steps=2, log_every_n_steps=2, val_every_n_steps=3,
                        save_every_n_steps=4, profile_steps=1,
                        profile_dir=str(tmp_path / "trace"))
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    state, tx = ttrainer.init_train_state(params, tc)
    batches = make_batches(jax_tiny(**KW), 5, accumulate=2)
    val = make_batches(jax_tiny(**KW), 2)
    logs, saved = [], []
    mgr = type("Mgr", (), {"save": lambda self, st, step: saved.append(step)})()
    state = ttrainer.train_loop(cfg, tc, state, tx, batches, val_batches_fn=lambda: val,
                                checkpoint_manager=mgr, log_fn=lambda s, m: logs.append((s, m)),
                                max_steps=4, device="cpu")
    assert state.step == 4 and saved == [4]
    assert [s for s, m in logs if "loss" in m] == [2, 4]
    assert [s for s, m in logs if "val/loss" in m] == [3]
    assert all(np.isfinite(m["loss"]) and m["steps_per_s"] > 0 for s, m in logs if "loss" in m)
    (path,) = (tmp_path / "trace").glob("*.pt.trace.json")  # what device_op_summary reads
    assert path.stat().st_size > 0


def _tiny_state(tc, seed=0):
    cfg = tiny_debug_config(**KW)
    params = init_params(cfg, torch.Generator().manual_seed(seed), device="cpu")
    return cfg, ttrainer.init_train_state(params, tc)


def test_checkpoint_manager_save_load_keep_last_and_resume(tmp_path):
    tc = TrainingConfig(**HPARAMS)
    cfg, (state, tx) = _tiny_state(tc)
    step = ttrainer.make_train_step(cfg, tc, tx)
    batch = make_batches(jax_tiny(**KW), 1)[0]
    mgr = CheckpointManager(str(tmp_path), keep_last_n=2, run_name="run_a", config=tc)
    mgr.save(state, 0)  # step 0 is skipped
    assert not list(mgr.run_dir.glob("step_*"))
    for _ in range(3):
        state, _ = step(state, batch, 1)
        mgr.save(state)
    assert [p.name for p in sorted(mgr.run_dir.glob("step_*"))] == ["step_000002", "step_000003"]
    latest = CheckpointManager.latest_checkpoint(str(tmp_path))
    assert latest == mgr.run_dir / "step_000003" == CheckpointManager.latest_step_dir(mgr.run_dir)
    ckpt, n, reinit = CheckpointManager.load(str(latest), tc)
    assert n == 3 and not reinit
    for a, b in zip(toptim.tree_leaves(ckpt["params"]), toptim.tree_leaves(state.params)):
        assert torch.equal(a, b.detach())
    # resume: a fresh optimizer loaded from the checkpoint holds the same
    # moments and count, and steps as the original (to the CPU kernels'
    # summation order, which can follow the buffers' alignment)
    tx2 = toptim.create_optimizer(tc, ckpt["params"])
    tx2.load_state_dict(ckpt["opt_state"])
    assert tx2.param_groups[0]["count"] == tx.param_groups[0]["count"] == 3
    for p1, p2 in zip(tx.param_groups[0]["params"], tx2.param_groups[0]["params"]):
        for k in ("mu", "nu"):
            assert torch.equal(tx.state[p1][k], tx2.state[p2][k])
        assert tx.state[p1]["decay"] == tx2.state[p2]["decay"]
    state2 = ttrainer.TrainState(ckpt["params"], tx2, n)
    s_a, m_a = step(state, batch, 7)
    s_b, m_b = ttrainer.make_train_step(cfg, tc, tx2)(state2, batch, 7)
    assert s_b.step == 4
    torch.testing.assert_close(m_b["loss"], m_a["loss"], rtol=1e-6, atol=1e-6)
    for a, b in zip(toptim.tree_leaves(s_a.params), toptim.tree_leaves(s_b.params)):
        torch.testing.assert_close(b, a, rtol=1e-5, atol=1e-7)
    # changed optimizer hparams reinitialize the optimizer
    assert CheckpointManager.load(str(latest), TrainingConfig(**dict(HPARAMS, eps=1e-6)))[2]
    assert not CheckpointManager.load(str(latest), TrainingConfig(**dict(HPARAMS, seed=9)))[2]
    # a newer run's equal step is preferred by name
    mgr_b = CheckpointManager(str(tmp_path), keep_last_n=2, run_name="run_b", config=tc)
    mgr_b.save(state, 3)
    assert CheckpointManager.latest_checkpoint(str(tmp_path)) == mgr_b.run_dir / "step_000003"


def _init_folder(d, cfg):
    from smoltts_torch.io.checkpoint import save_params

    save_byte_level_tokenizer(d, cfg.codebook_size)
    save_params(init_params(cfg, torch.Generator().manual_seed(0), device="cpu"), cfg, d)


def test_main_trains_checkpoints_and_auto_resumes(tmp_path, capsys):
    from datasets import Dataset

    from smoltts_torch.train.main import main

    cfg = tiny_debug_config(**KW)
    _init_folder(tmp_path / "init", cfg)
    tok = TokenConfig.smoltts_v0(CB)
    rows = tdata.synthetic_dataset(24, cfg, tok, seq_len=24, seed=0)
    Dataset.from_dict({"ground_truth": [r["ground_truth"].tolist() for r in rows]}).save_to_disk(
        str(tmp_path / "ds"))
    run = dict(HPARAMS, init_folder=str(tmp_path / "init"), dataset_path=str(tmp_path / "ds"),
               checkpoint_path=str(tmp_path / "ckpt"), batch_size=2, max_epochs=3,
               max_sequence_length=24, use_bf16=False, use_pretrained=True,
               save_every_n_steps=2, val_every_n_steps=2, log_every_n_steps=1,
               keep_last_n_checkpoints=2, auto_resume=True, unknown_key="ignored")
    (tmp_path / "run.json").write_text(json.dumps(run))
    assert load_training_config(tmp_path / "run.json").batch_size == 2
    state = main(["--config", str(tmp_path / "run.json"), "--max-steps", "4", "--device", "cpu"])
    assert state.step == 4
    out = capsys.readouterr().out
    assert "step 4:" in out and "val/loss" in out
    latest = CheckpointManager.latest_checkpoint(str(tmp_path / "ckpt"))
    assert latest.name == "step_000004"
    state = main(["--config", str(tmp_path / "run.json"), "--max-steps", "2", "--device", "cpu"])
    assert f"auto-resume: restarting from {latest}" in capsys.readouterr().out
    assert state.step == 6
    # main refuses what JAX refuses: a mesh whose product is not the world
    # (one process here: JAX's make_mesh over one device), and a batch that
    # does not split over the data ranks
    from smoltts_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from smoltts_torch.parallel.mesh import Mesh
    from smoltts_torch.train.main import rank_batch_size

    for axes in ((-1, 2), (2, 1), (2, 2)):
        with pytest.raises(AssertionError) as jax_err:
            jax_make_mesh(*axes, devices=jax.devices()[:1])
        (tmp_path / "mesh.json").write_text(json.dumps(dict(run, mesh_data_axis=axes[0],
                                                            mesh_model_axis=axes[1])))
        with pytest.raises(ValueError) as err:
            main(["--config", str(tmp_path / "mesh.json"), "--device", "cpu"])
        assert str(err.value) == str(jax_err.value), axes
    assert rank_batch_size(4, Mesh(2, 1)) == 2 and rank_batch_size(3, None) == 3
    with pytest.raises(ValueError, match="batch_size 3 does not split over 2 data ranks"):
        rank_batch_size(3, Mesh(2, 2, 1, 0))


def test_convert_round_trip_and_jax_parity(tmp_path):
    """convert writes the release layout from the port's train step dir and
    from a torch .pt; load_params reads back the trained tree bit for bit;
    the JAX converter writes the same safetensors from the same .pt."""
    cfg = tiny_debug_config(**KW)
    cfg.save(tmp_path / "config.json")
    tc = TrainingConfig(**HPARAMS)
    _, (state, tx) = _tiny_state(tc)
    mgr = CheckpointManager(str(tmp_path / "ck"), run_name="run", config=tc)
    mgr.save(state, 5)
    n = tconvert.convert(mgr.run_dir / "step_000005", tmp_path / "config.json", tmp_path / "rel",
                         device="cpu")
    assert n == sum(p.numel() for p in toptim.tree_leaves(state.params))
    back = tci.load_params(tmp_path / "rel", cfg, device="cpu")
    for a, b in zip(toptim.tree_leaves(back), toptim.tree_leaves(state.params)):
        assert torch.equal(a, b.detach())

    sd = tci.state_dict_from_params(tree_map(lambda t: t.detach(), state.params), cfg)
    torch.save({"model_state_dict": sd}, tmp_path / "model.pt")
    tconvert.main(["--src", str(tmp_path / "model.pt"), "--config", str(tmp_path / "config.json"),
                   "-o", str(tmp_path / "t_out"), "--dtype", "bfloat16", "--device", "cpu"])
    jax_convert.main(["--src", str(tmp_path / "model.pt"), "--config",
                      str(tmp_path / "config.json"), "-o", str(tmp_path / "j_out"),
                      "--dtype", "bfloat16"])
    got, ref = load_file(tmp_path / "t_out" / "model.safetensors"), load_file(
        tmp_path / "j_out" / "model.safetensors")
    assert got.keys() == ref.keys()
    for k in ref:
        assert got[k].dtype == ref[k].dtype == torch.bfloat16
        assert torch.equal(got[k].view(torch.int16), ref[k].view(torch.int16)), k
    (tmp_path / "orbax" / "state").mkdir(parents=True)
    with pytest.raises(ValueError, match="Orbax"):
        tconvert.convert(tmp_path / "orbax", tmp_path / "config.json", tmp_path / "x",
                         device="cpu")
