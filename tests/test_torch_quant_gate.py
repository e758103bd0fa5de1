"""PyTorch port, the quant gates against the JAX package's
(smoltts_tpu/ops/quant_gate.py) on the same trees (tests/test_quant_gate.py's
tiny config and Mimi), the kv8 gate fed JAX's own random query: every metric
within 1e-3 relative, the kv8 round-trip SNR within 0.01 dB. For that
comparison the LM is drawn with initializer_range 0.2: at the tiny config's
0.02 the int8 metrics are ~1e-7, the f32 resolution of the quantities they
difference (KL token 1.7e-7, flip mass 0), where no two implementations
agree to 1e-3; at 0.2 they sit near the 150M tree's (KL token 1.2e-3, JS
5.3e-3). The failing direction mirrors tests/test_quant_gate.py; the cached
verdict hits and invalidates."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smoltts_tpu.codec.config import MimiConfig as JaxMimiConfig
from smoltts_tpu.codec.mimi import init_mimi_params as jax_init_mimi
from smoltts_tpu.config import ModelType as JaxModelType
from smoltts_tpu.config import tiny_debug_config as jax_tiny
from smoltts_tpu.lm.samplers import GenerationSettings as JaxSettings
from smoltts_tpu.models.dual_ar import init_params as jax_init
from smoltts_tpu.ops import quant as jq
from smoltts_tpu.ops import quant_gate as jgate
from smoltts_tpu.tokenizer import ByteTokenizer as JaxByteTokenizer
from smoltts_tpu.tokenizer import TokenConfig as JaxTokenConfig
from smoltts_torch.codec.config import MimiConfig
from smoltts_torch.config import ModelType, tiny_debug_config
from smoltts_torch.interop import params_from_jax_numpy
from smoltts_torch.lm.samplers import GenerationSettings
from smoltts_torch.ops import quant_gate as tgate
from smoltts_torch.ops.quant import QTensor
from smoltts_torch.tokenizer import ByteTokenizer, TokenConfig
from tests import torch_threads  # noqa: F401  (one intra-op thread)

CB = 64
MIMI = dict(num_filters=8, upsampling_ratios=[4, 3, 2], hidden_size=32, num_hidden_layers=2,
            num_attention_heads=2, head_dim=16, intermediate_size=64, codebook_size=CB,
            codebook_dim=16, num_quantizers=8, upsample_groups=32, frame_rate=500.0)
SETTINGS = dict(default_temp=0.7, default_fast_temp=0.7, min_p=0.05)
REL = 1e-3


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


def _trees(initializer_range):
    kw = dict(codebook_size=CB, vocab_size=256 + 64 + CB, initializer_range=initializer_range)
    jcfg, cfg = jax_tiny(**kw), tiny_debug_config(**kw)
    jtok = JaxTokenConfig.from_tokenizer(JaxModelType.smoltts_v0(), JaxByteTokenizer(CB), jcfg)
    tok = TokenConfig.from_tokenizer(ModelType.smoltts_v0(), ByteTokenizer(CB), cfg)
    params = jax_init(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    qparams = jq.quantize_decode_params(params)
    mimi = jax_init_mimi(JaxMimiConfig(**MIMI), seed=1)
    qmimi = jq.quantize_mimi_params(mimi)
    jax_side = (jcfg, jtok, JaxMimiConfig(**MIMI), params, qparams, mimi, qmimi)
    port = (cfg, tok, MimiConfig(**MIMI)) + tuple(to_torch(t) for t in (params, qparams, mimi,
                                                                        qmimi))
    return jax_side, port


@pytest.fixture(scope="module")
def setup():
    return _trees(0.02)


@pytest.fixture(scope="module")
def measurable():
    return _trees(0.2)


def jax_query(jcfg, batch=2):
    return jax.random.normal(jax.random.PRNGKey(1), (batch, jcfg.n_head, jcfg.head_dim),
                             jnp.bfloat16)


def test_gate_metrics_match_jax(measurable):
    (jcfg, jtok, jmcfg, jp, jqp, jm, jqm), (cfg, tok, mcfg, p, qp, m, qm) = measurable
    ref = dict(jgate.gate_int8_lm(jcfg, jtok, jp, jqp))
    ref.update(jgate.gate_int8_vocoder(jcfg, jtok, JaxSettings(**SETTINGS), jmcfg, jp, jm, jqm))
    ref.update(jgate.gate_kv8(jcfg, jtok, jp))
    q = np.array(jax_query(jcfg).astype(jnp.float32))
    got = dict(tgate.gate_int8_lm(cfg, tok, p, qp))
    got.update(tgate.gate_int8_vocoder(cfg, tok, GenerationSettings(**SETTINGS), mcfg, p, m, qm))
    got.update(tgate.gate_kv8(cfg, tok, p, query=torch.from_numpy(q)))
    assert got.keys() == ref.keys()
    for k, v in ref.items():
        if k == "kv8_roundtrip_snr_db":
            assert abs(got[k] - v) < 0.01, (k, got[k], v)
        else:
            np.testing.assert_allclose(got[k], v, rtol=REL, err_msg=k)
    # the port's own query (another draw) passes the same gate
    assert tgate.gate_kv8(cfg, tok, p)["kv8_attention_rel_err"] < 0.02
    assert tuple(tgate.kv8_gate_query(2, cfg.n_head, cfg.head_dim).shape) == q.shape


def test_gate_prompts_equal_jax(setup):
    (jcfg, jtok, *_), (cfg, tok, *_) = setup
    rng = np.random.default_rng(0)
    c0 = rng.integers(1, CB, (2, 48))
    ref = np.zeros((2, cfg.num_rows, 48), np.int32)
    ref[:, 0], ref[:, 1] = jtok.semantic_start_id + c0, c0
    np.testing.assert_array_equal(tgate.kv8_gate_prompt(cfg, tok), ref)
    assert tgate.vocoder_gate_prompt(cfg, tok).shape == (cfg.num_rows, 12)


def _corrupt_head(qparams):
    """The fast output head's scales 4x (tests/test_quant_gate.py::_corrupt)."""
    out = dict(qparams)
    w = out["fast_output"]
    assert isinstance(w, QTensor)
    out["fast_output"] = QTensor(q=w.q, scale=w.scale * 4.0)
    return out


def test_int8_gate_fails_loudly_on_corruption(setup):
    _, (cfg, tok, _, p, qp, _, _) = setup
    with pytest.raises(tgate.QuantGateError, match="int8 LM gate failed"):
        tgate.gate_int8_lm(cfg, tok, p, _corrupt_head(qp))


def test_vocoder_gate_fails_loudly_on_corruption(setup):
    _, (cfg, tok, mcfg, p, _, m, qm) = setup
    bad = dict(qm)
    trunk = dict(bad["decoder_transformer"])
    lp = dict(trunk["layers"])
    for key in list(lp):
        if isinstance(lp[key], QTensor):
            lp[key] = QTensor(q=lp[key].q, scale=lp[key].scale * 8.0)
    trunk["layers"] = lp
    bad["decoder_transformer"] = trunk
    with pytest.raises(tgate.QuantGateError, match="vocoder"):
        tgate.gate_int8_vocoder(cfg, tok, GenerationSettings(), mcfg, p, m, bad)


def test_kv8_gate_fails_on_a_broken_read(setup, monkeypatch):
    """A kv8 read that ignores the value scales fails the attention check."""
    from smoltts_torch.ops import attention

    _, (cfg, tok, _, p, *_) = setup
    real = attention.decode_attention_tailed

    def no_v_scale(*args, k_scale=None, v_scale=None):
        return real(*args, k_scale=k_scale, v_scale=None if v_scale is None else v_scale * 0 + 1)

    monkeypatch.setattr(attention, "decode_attention_tailed", no_v_scale)
    with pytest.raises(tgate.QuantGateError, match="kv8 gate failed"):
        tgate.gate_kv8(cfg, tok, p)


def test_run_quant_gates_cached_hits_and_invalidates(setup, tmp_path, monkeypatch):
    _, (cfg, tok, mcfg, p, qp, m, qm) = setup
    settings = GenerationSettings(**SETTINGS)
    cache = tmp_path / "gate_cache.json"
    args = (cfg, tok, settings, mcfg, p, qp, m, qm)
    m1 = tgate.run_quant_gates_cached(*args, int8=True, kv8=True, cache_path=str(cache),
                                      device="cpu")
    assert "gate_cached" not in m1 and m1["int8_ce_delta"] < 0.02
    assert m1 == tgate.run_quant_gates(*args, int8=True, kv8=True, device="cpu")
    m2 = tgate.run_quant_gates_cached(*args, int8=True, kv8=True, cache_path=str(cache),
                                      device="cpu")
    assert m2.pop("gate_cached") == 1.0 and m2 == m1
    # another mode, another config, or a forced fresh run misses
    m3 = tgate.run_quant_gates_cached(*args, int8=False, kv8=True, cache_path=str(cache),
                                      device="cpu")
    assert "gate_cached" not in m3 and set(m3) == {"kv8_roundtrip_snr_db",
                                                   "kv8_attention_rel_err"}
    cfg2 = cfg.replace(norm_eps=1e-6)
    m4 = tgate.run_quant_gates_cached(cfg2, *args[1:], int8=False, kv8=True,
                                      cache_path=str(cache), device="cpu")
    assert "gate_cached" not in m4
    monkeypatch.setenv("SMOLTTS_GATE_NO_CACHE", "1")
    assert "gate_cached" not in tgate.run_quant_gates_cached(
        cfg2, *args[1:], int8=False, kv8=True, cache_path=str(cache), device="cpu")
    # a failing gate raises every time and is never cached
    monkeypatch.delenv("SMOLTTS_GATE_NO_CACHE")
    bad = (cfg, tok, settings, mcfg, p, _corrupt_head(qp), m, qm)
    for _ in range(2):
        with pytest.raises(tgate.QuantGateError):
            tgate.run_quant_gates_cached(*bad, int8=True, kv8=False,
                                         cache_path=str(tmp_path / "bad.json"), device="cpu")
    assert not (tmp_path / "bad.json").exists()


def test_mimi_decode_on_fused_int8_tree_matches_jax(setup):
    """The vocoder gate's input: batch mimi_decode on a fused and int8 Mimi
    tree (what bench.py hands the gate) equals JAX's on the same tree."""
    from smoltts_tpu.codec.mimi import mimi_decode as jax_decode
    from smoltts_torch.codec.mimi import mimi_decode

    (_, _, jmcfg, _, _, jm, _), (_, _, mcfg, *_) = setup
    tree = jq.quantize_mimi_params(jq.fuse_mimi_decode_params(jm))
    codes = np.random.default_rng(0).integers(0, CB, (2, 8, 6)).astype(np.int32)
    ref = np.asarray(jax_decode(tree, jmcfg, jnp.asarray(codes)))
    got = mimi_decode(to_torch(tree), mcfg, torch.from_numpy(codes)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)
