"""PyTorch port, sampler: the exact cases against the JAX package's Pallas
sampler (interpret mode), and the plain version's distribution against the
masked softmax it samples."""

import math

import jax.numpy as jnp
import numpy as np
import torch
from jax.experimental.pallas import tpu as pltpu

from smoltts_tpu.ops.sampling import sample_categorical_pallas
from smoltts_torch.lm.samplers import constrain_logits_to_audio, sample_token
from smoltts_torch.ops.sampling import sample_categorical, sample_categorical_plain


def test_min_p_one_is_greedy():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((4, 256)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(sample_categorical_pallas(
            jnp.asarray(logits), jnp.arange(4, dtype=jnp.int32), temperature=0.8, min_p=1.0))
    gen = torch.Generator().manual_seed(0)
    got = sample_categorical(torch.from_numpy(logits), gen, temperature=0.8, min_p=1.0).numpy()
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, np.argmax(logits, -1))


def test_one_hot_logits_give_the_hot_index():
    logits = np.full((2, 128), -100.0, np.float32)
    logits[0, 7] = 100.0
    logits[1, 100] = 100.0
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(sample_categorical_pallas(
            jnp.asarray(logits), jnp.asarray([1, 2], jnp.int32), temperature=1.0))
    gen = torch.Generator().manual_seed(1)
    got = sample_categorical_plain(torch.from_numpy(logits), gen, temperature=1.0).numpy()
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, [7, 100])


def test_temperature_zero_is_argmax():
    logits = torch.from_numpy(np.random.default_rng(2).standard_normal((3, 64)).astype(np.float32))
    out = sample_categorical(logits, None, temperature=0.0)
    np.testing.assert_array_equal(out.numpy(), logits.argmax(-1).numpy())
    assert out.dtype == torch.int32


def test_distribution_matches_masked_softmax():
    """Chi-square and total-variation check of the plain sampler at T=0.7,
    min_p=0.05 over 200k draws of one row: the masked softmax is the law."""
    rng = np.random.default_rng(3)
    V, N, T, min_p = 64, 200_000, 0.7, 0.05
    row = (rng.standard_normal(V) * 1.5).astype(np.float32)
    gen = torch.Generator().manual_seed(4)
    draws = sample_token(torch.from_numpy(np.tile(row, (N, 1))), gen, temperature=T, min_p=min_p)
    freq = np.bincount(draws.numpy(), minlength=V) / N
    scaled = row.astype(np.float64) / T
    keep = scaled >= scaled.max() + math.log(min_p)
    p = np.where(keep, np.exp(scaled - scaled.max()), 0.0)
    p /= p.sum()
    assert freq[~keep].sum() == 0.0
    tv = 0.5 * np.abs(freq - p).sum()
    # E[TV] ~ sum sqrt(p(1-p)/(2 pi N)) < 0.01 here; 0.01 leaves a wide margin.
    assert tv < 0.01, tv
    k = keep & (p * N >= 5)
    chi2 = (((freq[k] - p[k]) * N) ** 2 / (p[k] * N)).sum()
    dof = int(k.sum()) - 1
    # 99.9th percentile of chi-square by the Wilson-Hilferty approximation
    z = 3.09
    crit = dof * (1 - 2 / (9 * dof) + z * math.sqrt(2 / (9 * dof))) ** 3
    assert chi2 < crit, (chi2, crit)


def test_constrain_logits_to_audio():
    logits = torch.zeros((1, 10))
    out = constrain_logits_to_audio(logits, 2, 5, 7).numpy()[0]
    assert np.isfinite(out[[2, 5, 6, 7]]).all() and np.isinf(out[[0, 1, 3, 4, 8, 9]]).all()
