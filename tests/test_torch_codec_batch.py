"""PyTorch port, the Mimi codec's batch side against the JAX package: HF
weight import and `load_mimi` (bit-exact), `mimi_decode`, `mimi_encode`
(codes equal), the SEANet stacks, the whole-sequence codec transformer and
the transpose conv; and, in the port, streaming decode equal to batch
decode. Small Mimi, random HF weights."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smoltts_tpu.codec import conv as jconv
from smoltts_tpu.codec import mimi as jm
from smoltts_tpu.codec import seanet as jseanet
from smoltts_tpu.codec import transformer as jtf
from smoltts_tpu.codec.config import MimiConfig as JaxMimiConfig
from smoltts_tpu.ops import quant as jq
from smoltts_torch.codec import conv as tconv
from smoltts_torch.codec import mimi as tm
from smoltts_torch.codec import seanet as tseanet
from smoltts_torch.codec import transformer as ttf
from smoltts_torch.codec.config import MimiConfig
from smoltts_torch.interop import params_from_jax_numpy
from smoltts_torch.io.safetensors import save_file
from tests import torch_threads  # noqa: F401  (one intra-op thread)

SMALL = dict(
    num_filters=8, upsampling_ratios=[4, 3, 2], hidden_size=32, num_hidden_layers=2,
    num_attention_heads=2, head_dim=16, intermediate_size=64, codebook_size=64,
    codebook_dim=16, num_quantizers=8, upsample_groups=32, sampling_rate=24_000,
    frame_rate=500.0,
)
TOL = dict(rtol=1e-4, atol=1e-5)


def _hf_config(cfg):
    from transformers import MimiConfig as HFConfig

    return HFConfig(
        num_filters=cfg.num_filters, upsampling_ratios=cfg.upsampling_ratios,
        hidden_size=cfg.hidden_size, num_hidden_layers=cfg.num_hidden_layers,
        num_attention_heads=cfg.num_attention_heads, num_key_value_heads=cfg.num_attention_heads,
        head_dim=cfg.head_dim, intermediate_size=cfg.intermediate_size,
        codebook_size=cfg.codebook_size, codebook_dim=cfg.codebook_dim,
        vector_quantization_hidden_dimension=cfg.codebook_dim,
        num_quantizers=cfg.num_quantizers, num_semantic_quantizers=cfg.num_semantic_quantizers,
        upsample_groups=cfg.upsample_groups, sampling_rate=cfg.sampling_rate,
        frame_rate=cfg.frame_rate, sliding_window=cfg.sliding_window,
    )


@pytest.fixture(scope="module")
def codec():
    """(HF state dict as torch tensors, JAX tree, port tree, JAX cfg, port cfg)
    from one random HF MimiModel, built as tests/test_mimi_parity.py builds it
    (codebooks given random values and usages)."""
    from transformers import MimiModel

    jcfg, cfg = JaxMimiConfig(**SMALL), MimiConfig(**SMALL)
    torch.manual_seed(0)
    hf = MimiModel(_hf_config(cfg)).eval()
    sd = hf.state_dict()
    g = torch.Generator().manual_seed(1)
    for k in list(sd):
        if k.endswith("codebook.embed_sum"):
            sd[k] = torch.randn(sd[k].shape, generator=g)
        elif k.endswith("codebook.cluster_usage"):
            sd[k] = torch.rand(sd[k].shape, generator=g) + 0.5
    state = {k: v.float().contiguous() for k, v in sd.items()}
    jparams = jm.params_from_hf_state_dict({k: v.numpy() for k, v in state.items()}, jcfg)
    params = tm.params_from_hf_state_dict(state, cfg)
    return state, jparams, params, jcfg, cfg


def _assert_same_tree(got, ref, path=""):
    if isinstance(ref, dict):
        assert set(got) == set(ref), path
        for k in ref:
            _assert_same_tree(got[k], ref[k], f"{path}.{k}")
    elif isinstance(ref, list):
        assert len(got) == len(ref), path
        for i, (a, b) in enumerate(zip(got, ref)):
            _assert_same_tree(a, b, f"{path}.{i}")
    elif ref is None:
        assert got is None, path
    else:
        a, b = got.numpy(), np.asarray(ref)
        assert a.shape == b.shape and a.dtype == b.dtype, (path, a.shape, b.shape)
        np.testing.assert_array_equal(a, b, err_msg=path)


def test_params_from_hf_state_dict_bit_exact(codec):
    state, jparams, params, jcfg, cfg = codec
    _assert_same_tree(params, jparams)
    # usages at or below the 1e-5 floor
    state = dict(state)
    for k in [k for k in state if k.endswith("cluster_usage")]:
        state[k] = state[k] * (torch.arange(state[k].numel()) % 5 != 0) - 1e-7 * (
            torch.arange(state[k].numel()) % 7 == 0)
    _assert_same_tree(tm.params_from_hf_state_dict(state, cfg),
                      jm.params_from_hf_state_dict({k: v.numpy() for k, v in state.items()}, jcfg))


def test_load_mimi_bit_exact(codec, tmp_path):
    state, jparams, _, jcfg, cfg = codec
    path = tmp_path / "mimi.safetensors"
    save_file(state, path)
    got, got_cfg = tm.load_mimi(path, cfg, device="cpu")
    ref, _ = jm.load_mimi(path, jcfg)
    assert got_cfg is cfg
    _assert_same_tree(got, ref)
    _assert_same_tree(got, jparams)
    bf, _ = tm.load_mimi(path, cfg, dtype=torch.bfloat16, device="cpu")
    assert bf["decoder"][0]["w"].dtype == torch.bfloat16


@pytest.mark.parametrize("T", [1, 7])
def test_mimi_decode_matches_jax(codec, T):
    _, jparams, params, jcfg, cfg = codec
    codes = np.random.default_rng(T).integers(0, cfg.codebook_size, (2, 8, T)).astype(np.int32)
    ref = np.asarray(jm.mimi_decode(jparams, jcfg, jnp.asarray(codes)))
    got = tm.mimi_decode(params, cfg, torch.from_numpy(codes)).numpy()
    assert got.shape == (2, T * cfg.samples_per_frame, 1) == ref.shape
    np.testing.assert_allclose(got, ref, **TOL)


@pytest.mark.parametrize("frames,extra", [(5, 17), (3, 0), (1, 1)])
def test_mimi_encode_codes_equal_jax(codec, frames, extra):
    _, jparams, params, jcfg, cfg = codec
    hop = cfg.samples_per_frame
    audio = (np.random.default_rng(frames).standard_normal((2, hop * frames + extra)) * 0.3)
    audio = audio.astype(np.float32)
    ref = np.asarray(jm.mimi_encode(jparams, jcfg, jnp.asarray(audio), num_quantizers=8))
    got = tm.mimi_encode(params, cfg, torch.from_numpy(audio), num_quantizers=8).numpy()
    assert got.dtype == np.int32 and got.shape == ref.shape == (2, 8, frames + (extra > 0))
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("side", ["encoder", "decoder"])
def test_seanet_apply_matches_jax(codec, side):
    _, jparams, params, jcfg, cfg = codec
    rng = np.random.default_rng(2)
    if side == "encoder":
        jplan, plan = jseanet.build_encoder_plan(jcfg), tseanet.build_encoder_plan(cfg)
        x = rng.standard_normal((2, cfg.samples_per_frame * 2 + 5, 1)).astype(np.float32)
    else:
        jplan, plan = jseanet.build_decoder_plan(jcfg), tseanet.build_decoder_plan(cfg)
        x = rng.standard_normal((2, 6, cfg.hidden_size)).astype(np.float32)
    ref = np.asarray(jseanet.seanet_apply(jplan, jparams[side], jnp.asarray(x), jcfg))
    got = tseanet.seanet_apply(plan, params[side], torch.from_numpy(x), cfg).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, **TOL)


@pytest.mark.parametrize("leaves", ["plain", "fused_int8"])
@pytest.mark.parametrize("T", [5, 300])  # 300 > the 250-token sliding window
def test_transformer_forward_matches_jax(codec, leaves, T):
    _, jparams, _, jcfg, cfg = codec
    jtree = jparams["decoder_transformer"]
    if leaves == "fused_int8":
        jtree = jq.quantize_mimi_params(jq.fuse_mimi_decode_params(
            {"decoder_transformer": jtree}))["decoder_transformer"]
    tree = params_from_jax_numpy(jax.tree.map(np.asarray, jtree))
    x = np.random.default_rng(T).standard_normal((2, T, cfg.hidden_size)).astype(np.float32)
    ref = np.asarray(jtf.transformer_forward(jtree, jcfg, jnp.asarray(x)))
    got = ttf.transformer_forward(tree, cfg, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("groups,trim", [(1, 1.0), (1, 0.5), ("depthwise", 1.0)])
def test_causal_conv_transpose1d_matches_jax(groups, trim):
    rng = np.random.default_rng(3)
    C, K, stride = 6, 4, 2
    g = C if groups == "depthwise" else 1
    w = rng.standard_normal((K, C // g, C)).astype(np.float32)
    b = rng.standard_normal((C,)).astype(np.float32)
    x = rng.standard_normal((2, 9, C)).astype(np.float32)
    ref = np.asarray(jconv.causal_conv_transpose1d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                                                   stride=stride, groups=g, trim_right_ratio=trim))
    got = tconv.causal_conv_transpose1d(torch.from_numpy(x), torch.from_numpy(w),
                                        torch.from_numpy(b), stride=stride, groups=g,
                                        trim_right_ratio=trim).numpy()
    assert got.shape == ref.shape == (2, 9 * stride, C)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mode", ["constant", "replicate", "reflect"])
@pytest.mark.parametrize("length,stride", [(10, 2), (3, 1), (17, 4)])
def test_causal_conv1d_matches_jax(mode, length, stride):
    rng = np.random.default_rng(length)
    w = rng.standard_normal((5, 3, 4)).astype(np.float32)
    x = rng.standard_normal((2, length, 3)).astype(np.float32)
    ref = np.asarray(jconv.causal_conv1d(jnp.asarray(x), jnp.asarray(w), None, stride=stride,
                                         dilation=2, pad_mode=mode))
    got = tconv.causal_conv1d(torch.from_numpy(x), torch.from_numpy(w), None, stride=stride,
                              dilation=2, pad_mode=mode).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_streaming_equals_batch_in_the_port(codec):
    _, _, params, _, cfg = codec
    T = 6
    codes = torch.from_numpy(np.random.default_rng(4).integers(0, cfg.codebook_size, (2, 8, T)))
    batch = tm.mimi_decode(params, cfg, codes).numpy()
    state = tm.decode_stream_init(cfg, 2, device="cpu")
    chunks = []
    with torch.no_grad():
        for t in range(T):
            state, pcm = tm.mimi_decode_step(params, cfg, state, codes[:, :, t : t + 1])
            chunks.append(pcm.numpy())
    np.testing.assert_allclose(np.concatenate(chunks, axis=1), batch, rtol=2e-3, atol=1e-4)
