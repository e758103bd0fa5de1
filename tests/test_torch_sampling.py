"""PyTorch port, sampler: the exact cases against the JAX package's Pallas
sampler (interpret mode), and the plain version's distribution against the
masked softmax it samples. The slow-token site (window, sampling, finished
rows) against the JAX composition, exactly at temperature 0 and min_p = 1;
a plain emulation of the CUDA kernel's method (Philox noise, checked on
Random123's known answers) against the masked softmax; and the kernel's
host side that runs without a card (ctypes declaration, refused inputs)."""

import ctypes
import math
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from smoltts_tpu.lm.samplers import constrain_logits_to_audio as jax_constrain
from smoltts_tpu.lm.samplers import sample_token as jax_sample_token
from smoltts_tpu.ops.sampling import sample_categorical_pallas
from smoltts_torch.lm.samplers import GenerationSettings, constrain_logits_to_audio, sample_token
from smoltts_torch.ops import _build
from smoltts_torch.ops import sampling as SP
from smoltts_torch.ops.sampling import sample_categorical, sample_categorical_plain
from smoltts_torch.tokenizer import TokenConfig
from tests.test_torch_attention import _c_functions
from tests import torch_threads  # noqa: F401  (one intra-op thread)


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


# ---- the slow-token site and the method of the CUDA kernel (csrc/sampling.cu) ----

_M32 = 0xFFFFFFFF


@pytest.mark.parametrize("ctr,key,want", [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((_M32,) * 4, (_M32, _M32), (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
], ids=["zeros", "ones", "pi"])
def test_philox_matches_random123_known_answers(ctr, key, want):
    """Random123's known-answer vectors for Philox4x32-10, which the kernel
    (common.cuh) and its emulation both implement."""
    t = lambda v: torch.tensor([v], dtype=torch.int64)
    got = SP.philox4x32_10(tuple(map(t, ctr)), tuple(map(t, key)))
    assert tuple(int(w) for w in got) == want


def test_gumbel_noise_layout():
    """Element (r, c) is word c % 4 of the Philox call with counter {c / 4, r,
    "SAMP", offset}, mapped to u = (top 23 bits + 0.5) / 2^23 in (0, 1)."""
    seed, offset, rows, cols = 0x0123456789ABCDEF & (2**62 - 1), 2**40 + 77, 3, 10
    noise = SP.philox_gumbel_plain(torch.tensor(seed), torch.tensor(offset), rows, cols).numpy()
    assert noise.dtype == np.float32 and noise.shape == (rows, cols)
    t = lambda v: torch.tensor([v], dtype=torch.int64)
    for r in range(rows):
        for c in range(cols):
            words = SP.philox4x32_10((t(c // 4), t(r), t(0x53414D50), t(offset & _M32)),
                                     (t(seed & _M32), t(seed >> 32)))
            u = ((int(words[c % 4]) >> 9) + 0.5) / 2**23
            assert 0.0 < u < 1.0
            np.testing.assert_allclose(noise[r, c], -math.log(-math.log(u)), rtol=1e-6, atol=1e-6)


_WINDOW_TOK = TokenConfig(im_end_id=5, pad_id=0, semantic_start_id=20, semantic_end_id=57)


@pytest.mark.parametrize("window", [False, True], ids=["no_window", "audio_window"])
def test_emulated_kernel_distribution_matches_masked_softmax(window):
    """The kernel's method (Philox noise, four columns per call) samples the
    masked softmax: chi-square and total variation over 200k draws of one
    row at T=0.7, min_p=0.05, V = 66 (not a multiple of 4)."""
    rng = np.random.default_rng(5)
    V, N, T, min_p = 66, 200_000, 0.7, 0.05
    row = (rng.standard_normal(V) * 1.5).astype(np.float32)
    row[3] = row.max() + 1.0  # outside the window: the window must move the law
    settings = GenerationSettings(default_temp=T, min_p=min_p, audio_only_constraint=window)
    logits = torch.from_numpy(np.tile(row, (N, 1)))
    gen = torch.Generator().manual_seed(6)
    draws = SP.sample_slow_token_emulated(logits, gen, settings, _WINDOW_TOK,
                                          torch.zeros(N, dtype=torch.bool))
    freq = np.bincount(draws.numpy(), minlength=V) / N
    scaled = row.astype(np.float64) / T
    if window:
        ids = np.arange(V)
        allowed = (ids == 5) | ((ids >= 20) & (ids <= 57))
        scaled = np.where(allowed, scaled, -np.inf)
    keep = scaled >= scaled.max() + math.log(min_p)
    p = np.where(keep, np.exp(scaled - scaled.max()), 0.0)
    p /= p.sum()
    assert freq[~keep].sum() == 0.0
    tv = 0.5 * np.abs(freq - p).sum()
    assert tv < 0.01, tv
    k = keep & (p * N >= 5)
    chi2 = (((freq[k] - p[k]) * N) ** 2 / (p[k] * N)).sum()
    dof = int(k.sum()) - 1
    z = 3.09  # 99.9th percentile, Wilson-Hilferty
    crit = dof * (1 - 2 / (9 * dof) + z * math.sqrt(2 / (9 * dof))) ** 3
    assert chi2 < crit, (chi2, crit)


def _site_case(dtype, seed=7):
    """Logits [6, 352] of the tiny vocab (im_end 270, semantic 320..351) as
    f32 numpy values exactly representable in `dtype`, whose maximum lies
    outside the audio window in every row; rows 1 and 4 finished."""
    tok = TokenConfig.smoltts_v0(32)
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((6, 352)).astype(np.float32) * 2.0
    logits[np.arange(6), rng.integers(0, 256, 6)] = 9.0
    if dtype == "bf16":
        logits = np.asarray(jnp.asarray(logits, jnp.bfloat16), np.float32)
    finished = np.zeros(6, bool)
    finished[[1, 4]] = True
    to_torch = torch.bfloat16 if dtype == "bf16" else torch.float32
    return tok, logits, finished, torch.from_numpy(logits).to(to_torch), torch.from_numpy(finished)


def _jax_site(tok, logits, finished, window, sample):
    x = jnp.asarray(logits, jnp.float32)
    if window:
        x = jax_constrain(x, tok.im_end_id, tok.semantic_start_id, tok.semantic_end_id)
    return np.asarray(jnp.where(jnp.asarray(finished), tok.im_end_id, sample(x)))


@pytest.mark.parametrize("window", [False, True], ids=["no_window", "audio_window"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_slow_token_site_greedy_matches_jax(dtype, window):
    """Temperature 0: the site's plain version, its emulation of the kernel
    and the CPU dispatch equal the JAX composition (cast, constrain,
    sample_token, where) exactly."""
    tok, logits, finished, tl, tf = _site_case(dtype)
    ref = _jax_site(tok, logits, finished, window,
                    lambda x: jax_sample_token(x, jax.random.PRNGKey(0), temperature=0.0))
    settings = GenerationSettings(default_temp=0.0, audio_only_constraint=window)
    for fn in (SP.sample_slow_token_plain, SP.sample_slow_token_emulated, SP.sample_slow_token):
        got = fn(tl, None, settings, tok, tf)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), ref)
    assert (ref[[1, 4]] == tok.im_end_id).all()
    if window:
        assert all(t == tok.im_end_id or 320 <= t <= 351 for t in ref)


@pytest.mark.parametrize("window", [False, True], ids=["no_window", "audio_window"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_slow_token_site_min_p_one_matches_pallas(dtype, window):
    """min_p = 1 keeps only the maximum, so the site is exact whatever the
    noise: the plain version and the emulation equal the JAX composition
    around the Pallas sampler (interpret mode)."""
    tok, logits, finished, tl, tf = _site_case(dtype, seed=8)
    with pltpu.force_tpu_interpret_mode():
        ref = _jax_site(tok, logits, finished, window, lambda x: sample_categorical_pallas(
            x, jnp.arange(6, dtype=jnp.int32), temperature=0.8, min_p=1.0))
    settings = GenerationSettings(default_temp=0.8, min_p=1.0, audio_only_constraint=window)
    for fn in (SP.sample_slow_token_plain, SP.sample_slow_token_emulated):
        got = fn(tl, torch.Generator().manual_seed(3), settings, tok, tf)
        np.testing.assert_array_equal(got.numpy(), ref)


def test_sample_tokens_argtypes_mirror_c():
    """The ctypes declaration of the sampler's C entry against its signature
    in sampling.cu (a mismatch passes arguments at the wrong width)."""
    src = (Path(__file__).resolve().parents[1] / "smoltts_torch" / "csrc" / "sampling.cu").read_text()
    want = _c_functions(src)
    assert set(want) == {"smoltts_sample_tokens"}

    class Handle(dict):
        def __getattr__(self, name):
            return self.setdefault(name, types.SimpleNamespace())

    h = Handle()
    _build._declare(h)
    assert h["smoltts_sample_tokens"].argtypes == want["smoltts_sample_tokens"]
    assert h["smoltts_sample_tokens"].restype is ctypes.c_int
    assert len(want["smoltts_sample_tokens"]) == 16


@pytest.mark.parametrize("case,match", [
    ("int32", "f32 or bf16"),
    ("float16", "f32 or bf16"),
    ("column_stride", "unit stride"),
    ("min_p_zero", "min_p"),
    ("finished_int", "finished"),
])
def test_kernel_wrapper_refuses_what_the_kernel_cannot_take(case, match):
    """Checked before anything is built or launched."""
    logits = torch.zeros(4, 64)
    kw = dict(temperature=0.7, min_p=None, finished=None)
    if case in ("int32", "float16"):
        logits = logits.to(getattr(torch, case))
    elif case == "column_stride":
        logits = torch.zeros(4, 128)[:, ::2]
    elif case == "min_p_zero":
        kw["min_p"] = 0.0
    elif case == "finished_int":
        kw["finished"] = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match=match):
        SP._kernel(logits, None, kw["temperature"], kw["min_p"], finished=kw["finished"])
