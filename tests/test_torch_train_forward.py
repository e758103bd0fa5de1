"""PyTorch port, the training forward against the JAX package: the
teacher-forced `forward_train` on dense, fused-w13 and int8 trees, unfolded
(F=1) and frame-folded (F=16), through `sdpa_blockwise` (T=512); the losses
and the time-chunked fused loss, values and gradients; and, in the port,
dropout's statistics and masks that survive activation recompute. The tiny
config is tests/test_quant_gate.py's; tolerances from PARITY.md (forward
allclose 5e-4 in f32, losses and gradients 1e-5)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smoltts_tpu.config import tiny_debug_config as jax_tiny
from smoltts_tpu.models import dual_ar as jd
from smoltts_tpu.models import layers as jlayers
from smoltts_tpu.ops import quant as jq
from smoltts_tpu.tokenizer import TokenConfig as JaxTokenConfig
from smoltts_tpu.train import loss as jloss
from smoltts_tpu.train.data import collate as jax_collate
from smoltts_tpu.train.data import synthetic_dataset as jax_synthetic
from smoltts_torch.config import tiny_debug_config
from smoltts_torch.interop import params_from_jax_numpy
from smoltts_torch.models import dual_ar as td
from smoltts_torch.models import layers as tlayers
from smoltts_torch.train import loss as tloss
from smoltts_torch.train.optim import tree_leaves
from tests import torch_threads  # noqa: F401  (one intra-op thread)

CB = 64
KW = dict(codebook_size=CB, vocab_size=256 + 64 + CB)
FWD = dict(rtol=5e-4, atol=5e-4)
LOSS = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads: the suite runs several workers on one host, and
    torch's default (one thread per core in every worker) oversubscribes it."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def trees():
    jcfg = jax_tiny(**KW)
    dense = jd.init_params(jcfg, jax.random.PRNGKey(0))
    fused = jq.fuse_decode_params(dense)
    out = {"dense": dense, "fused": fused, "int8": jq.quantize_decode_params(fused)}
    return jcfg, tiny_debug_config(**KW), {k: (v, to_torch(v)) for k, v in out.items()}


def to_torch(tree):
    return params_from_jax_numpy(jax.tree.map(np.asarray, tree))


def make_batch(cfg, B, T, seed=0):
    tok = JaxTokenConfig.smoltts_v0(cfg.codebook_size)
    rows = jax_synthetic(B, cfg, tok, seq_len=T, seed=seed)
    return jax_collate([r["ground_truth"] for r in rows], tok.pad_id, max_len=T)


@pytest.mark.parametrize("tree", ["dense", "fused", "int8"])
@pytest.mark.parametrize("fold,T", [("1", 16), ("16", 16), ("16", 512)])
def test_forward_train_matches_jax(trees, tree, fold, T, monkeypatch):
    """F=1 and F=16 over B*T=32 frames; T=512 routes the slow trunk through
    sdpa_blockwise in both packages."""
    monkeypatch.setenv("SMOLTTS_FAST_FOLD", fold)
    jcfg, cfg, t = trees
    jparams, params = t[tree]
    if T == 512:
        assert td.fast_fold(2 * T, cfg.max_fast_seqlen) == 16
    b = make_batch(jcfg, 2, T)
    ref = jax.jit(lambda p, x: jd.forward_train(p, jcfg, x))(jparams, jnp.asarray(b["tokens"]))
    got = td.forward_train(params, cfg, torch.from_numpy(b["tokens"]))
    for f in ("token_logits", "codebook_logits", "hidden_states"):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(ref, f)), **FWD,
                                   err_msg=f)


def test_fast_fold_equals_unfolded(trees, monkeypatch):
    """In the port, as in JAX (test_fast_fold_parity): folding 16 frames
    under the block-diagonal mask gives the unfolded logits."""
    _, cfg, t = trees
    tokens = torch.from_numpy(make_batch(cfg, 2, 24, seed=3)["tokens"])
    monkeypatch.setenv("SMOLTTS_FAST_FOLD", "1")
    ref = td.forward_train(t["dense"][1], cfg, tokens).codebook_logits
    monkeypatch.setenv("SMOLTTS_FAST_FOLD", "16")
    assert td.fast_fold(48, cfg.max_fast_seqlen) == 16
    got = td.forward_train(t["dense"][1], cfg, tokens).codebook_logits
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)


def _qkv(B, T, H, n_kv, hd, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, T, h, hd)).astype(np.float32) for h in (H, n_kv, n_kv)]


@pytest.mark.parametrize("T,causal,masked", [(512, True, False), (32, True, False),
                                             (32, False, True)])
def test_sdpa_matches_jax(T, causal, masked):
    q, k, v = _qkv(2, T, 4, 2, 16)
    mask = None
    if masked:  # the folded fast trunk's block-diagonal mask, rows of 8
        idx = np.arange(T)
        mask = ((idx[:, None] // 8) == (idx[None, :] // 8)) & (idx[:, None] >= idx[None, :])
    ref = jlayers.sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       None if mask is None else jnp.asarray(mask), is_causal=causal)
    got = tlayers.sdpa(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                       None if mask is None else torch.from_numpy(mask), is_causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_dropout_keep_statistics_and_determinism():
    for rate in (0.1, 0.5, 0.9):
        keep = tlayers.dropout_keep(7, rate, (512, 512))
        assert abs(float(keep.float().mean()) - (1.0 - rate)) < 0.01, rate
    assert bool(tlayers.dropout_keep(1, 0.0, (1024,)).all())
    a = tlayers.dropout_keep(tlayers.fold_in(3, 5), 0.3, (64, 64))
    assert torch.equal(a, tlayers.dropout_keep(tlayers.fold_in(3, 5), 0.3, (64, 64)))
    assert not torch.equal(a, tlayers.dropout_keep(tlayers.fold_in(3, 6), 0.3, (64, 64)))
    s1, s2 = tlayers.split_seed(11)
    assert len({s1, s2, tlayers.fold_in(11, 0), tlayers.fold_in(11, 1)}) == 4


@pytest.mark.parametrize("T", [32, 512])
def test_sdpa_dropout_is_mean_preserving(T):
    """E[dropout(attention)] = attention: the 1/(1-p) scale after P@V, in
    the eager (T=32, the folded mask with dropout_cols) and the blockwise
    (T=512) forms."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, T, 2, 2, 8, seed=1))
    mask, cols = None, None
    if T == 32:
        idx = torch.arange(T)
        mask = ((idx[:, None] // 8) == (idx[None, :] // 8)) & (idx[:, None] >= idx[None, :])
        cols = 8
    base = tlayers.sdpa(q, k, v, mask, is_causal=mask is None)
    outs = [tlayers.sdpa(q, k, v, mask, is_causal=mask is None, dropout_rate=0.3,
                         dropout_seed=100 + i, dropout_cols=cols) for i in range(48)]
    assert not torch.equal(outs[0], base)
    err = (torch.stack(outs).double().mean(0) - base).abs().mean() / base.abs().mean()
    assert float(err) < 0.15


def test_dropout_cols_draws_one_bit_per_column_class():
    """The folded fast trunk draws keep bits for n columns per row and
    expands them by col % n: every attendable key of a row keeps its own
    draw, so the keep rate over the valid entries is 1 - p."""
    T, n = 128, 8
    idx = torch.arange(T)
    mask = ((idx[:, None] // n) == (idx[None, :] // n)) & (idx[:, None] >= idx[None, :])
    q = k = torch.zeros(1, T, 1, T)  # uniform probabilities over the attendable keys
    v = torch.eye(T)[None, :, None, :]  # so the output rows are the dropped probabilities
    out = tlayers.sdpa(q, k, v, mask, dropout_rate=0.25, dropout_seed=9, dropout_cols=n)[0]
    probs = out.reshape(T, T)
    kept = (probs > 0) & mask
    frac = float(kept.sum()) / float(mask.sum())
    assert abs(frac - 0.75) < 0.06, frac
    assert not bool((probs > 0)[~mask].any())


def _train_cfg(cfg, dropout, remat):
    return cfg.replace(dropout=dropout, use_gradient_checkpointing=remat)


def _grads(params, cfg, tokens, labels, seed, chunk_t=0, policy="none"):
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    losses = tloss.forward_train_loss(params, cfg, tokens, labels, dropout_seed=seed,
                                      train=True, chunk_t=chunk_t, remat_policy=policy)
    grads = torch.autograd.grad(losses.total, leaves)
    for p in leaves:
        p.requires_grad_(False)
    return losses.total.detach(), grads


@pytest.mark.parametrize("chunk_t,policy", [(0, "none"), (0, "dots"), (4, "none")])
def test_remat_keeps_dropout_masks(trees, chunk_t, policy):
    """Gradients with activation checkpointing equal those without, with
    dropout 0.1 on: each site's mask comes from a seed, so recompute draws
    the same bits (per layer, per q-block of sdpa_blockwise at T=512, per
    time chunk)."""
    _, cfg, t = trees
    params = t["dense"][1]
    T = 512 if chunk_t == 0 else 16
    b = make_batch(cfg, 1 if T == 512 else 2, T, seed=4)
    tokens, labels = torch.from_numpy(b["tokens"]), torch.from_numpy(b["labels"])
    l0, g0 = _grads(params, _train_cfg(cfg, 0.1, False), tokens, labels, 21, chunk_t)
    l1, g1 = _grads(params, _train_cfg(cfg, 0.1, True), tokens, labels, 21, chunk_t, policy)
    torch.testing.assert_close(l1, l0, rtol=1e-6, atol=0)
    for a, b in zip(g0, g1):
        torch.testing.assert_close(b, a, rtol=1e-5, atol=1e-6)
    # dropout is engaged, and another seed draws other masks
    l2, _ = _grads(params, _train_cfg(cfg, 0.0, False), tokens, labels, 21, chunk_t)
    l3, _ = _grads(params, _train_cfg(cfg, 0.1, False), tokens, labels, 22, chunk_t)
    assert float(l0) != float(l2) and float(l0) != float(l3)


@pytest.mark.parametrize("per_codebook", [False, True])
def test_compute_losses_match_jax(per_codebook):
    rng = np.random.default_rng(0)
    tl = rng.standard_normal((2, 12, 40)).astype(np.float32)
    cl = rng.standard_normal((2, 12, 8, CB)).astype(np.float32)
    labels = rng.integers(0, CB, (2, 9, 12)).astype(np.int32)
    labels[:, 0] = rng.integers(0, 40, (2, 12))
    labels[:, :, 9:] = -100
    labels[0, 3, :4] = -100
    labels[1, 5, :] = -100  # one fully masked level
    ref = jloss.compute_losses(jnp.asarray(tl), jnp.asarray(cl), jnp.asarray(labels),
                               per_codebook=per_codebook)
    got = tloss.compute_losses(torch.from_numpy(tl), torch.from_numpy(cl),
                               torch.from_numpy(labels), per_codebook=per_codebook)
    for f in ("total", "base", "semantic") + (("per_codebook",) if per_codebook else ()):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(ref, f)), **LOSS)


@pytest.mark.parametrize("chunk_t", [0, 4, 16])
def test_chunked_loss_and_grads_match_jax(trees, chunk_t):
    """forward_train_loss (dense at chunk_t=0, time-chunked otherwise):
    losses and every gradient leaf against JAX's, and the chunked losses
    against the dense path's."""
    jcfg, cfg, t = trees
    jparams, params = t["dense"]
    b = make_batch(jcfg, 2, 16)

    def jax_total(p):
        out = jloss.forward_train_loss(p, jcfg, jnp.asarray(b["tokens"]),
                                       jnp.asarray(b["labels"]), chunk_t=chunk_t,
                                       per_codebook=True)
        return out.total, out

    (_, ref), g_ref = jax.jit(jax.value_and_grad(jax_total, has_aux=True))(jparams)
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    got = tloss.forward_train_loss(params, cfg, torch.from_numpy(b["tokens"]),
                                   torch.from_numpy(b["labels"]), chunk_t=chunk_t,
                                   per_codebook=True)
    grads = torch.autograd.grad(got.total, leaves)
    for p in leaves:
        p.requires_grad_(False)
    for f in ("total", "base", "semantic", "per_codebook"):
        np.testing.assert_allclose(getattr(got, f).detach().numpy(), np.asarray(getattr(ref, f)),
                                   **LOSS)
    for g, r in zip(grads, jax.tree.leaves(g_ref)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **LOSS)
    if chunk_t:
        dense = tloss.forward_train_loss(params, cfg, torch.from_numpy(b["tokens"]),
                                         torch.from_numpy(b["labels"]), per_codebook=True)
        np.testing.assert_allclose(got.total.detach().numpy(), dense.total.numpy(), rtol=1e-6)
