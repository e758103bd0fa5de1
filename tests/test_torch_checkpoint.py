"""PyTorch port, checkpoint I/O against the JAX package: the safetensors
reader and writer, the DualAR checkpoint loader and saver, the tokenizer
loader and writer, and WAV output. Loaders are bit-exact."""

import json

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from safetensors.numpy import load_file as st_load_file
from safetensors.numpy import save_file as st_save_file
from tokenizers import Tokenizer

from smoltts_tpu.config import tiny_debug_config as jax_tiny
from smoltts_tpu.io import checkpoint_interop as jci
from smoltts_tpu.io.wav import pcm_to_wav_bytes as jax_wav
from smoltts_tpu.io.wav import wav_header as jax_wav_header
from smoltts_tpu.models.dual_ar import init_params as jax_init
from smoltts_tpu.tokenizer import save_byte_level_tokenizer as jax_save_tokenizer
from smoltts_torch.config import DualARConfig, tiny_debug_config
from smoltts_torch.io import checkpoint as tci
from smoltts_torch.io import safetensors as tst
from smoltts_torch.io.wav import pcm_to_wav_bytes, wav_header
from smoltts_torch.tokenizer import ByteTokenizer, load_tokenizer, save_byte_level_tokenizer

DTYPES = {"f32": np.float32, "bf16": ml_dtypes.bfloat16, "f16": np.float16,
          "i32": np.int32, "i8": np.int8, "bool": np.bool_}


def _arrays(seed=0):
    rng = np.random.default_rng(seed)
    out = {}
    for i, (name, dt) in enumerate(DTYPES.items()):
        shape = [(3, 5), (7,), (2, 3, 4), (1,), (4, 4), (6,)][i]
        if dt == np.bool_:
            out[name] = rng.integers(0, 2, shape).astype(np.bool_)
        elif np.dtype(dt).kind in "iu":
            out[name] = rng.integers(-100, 100, shape).astype(dt)
        else:
            out[name] = (rng.standard_normal(shape) * 3).astype(np.float32).astype(dt)
    out["empty"] = np.zeros((0, 4), np.float32)
    return out


def _bits(a) -> np.ndarray:
    """numpy view that compares bit for bit (bf16 as int16)."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy()
        return a.numpy()
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype == ml_dtypes.bfloat16 else a


def _assert_same_tree(torch_tree, jax_tree, path=""):
    if isinstance(jax_tree, dict):
        assert set(torch_tree) == set(jax_tree), path
        for k in jax_tree:
            _assert_same_tree(torch_tree[k], jax_tree[k], f"{path}.{k}")
        return
    a, b = _bits(torch_tree), _bits(jax_tree)
    assert a.shape == b.shape and a.dtype == b.dtype, (path, a.shape, b.shape, a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b, err_msg=path)


@pytest.mark.parametrize("writer", ["jax_package", "safetensors"])
def test_reader_reads_reference_files_bit_exact(tmp_path, writer):
    arrays = _arrays()
    path = tmp_path / "x.safetensors"
    if writer == "jax_package":
        jci.save_safetensors(arrays, path)
    else:
        st_save_file(arrays, str(path))
    got = tst.load_file(path)
    assert set(got) == set(arrays)
    for k, a in arrays.items():
        assert tuple(got[k].shape) == a.shape
        np.testing.assert_array_equal(_bits(got[k]), _bits(a), err_msg=k)


def test_writer_output_reads_in_safetensors(tmp_path):
    arrays = _arrays(1)
    tensors = {k: (torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
                   if a.dtype == ml_dtypes.bfloat16 else torch.from_numpy(a))
               for k, a in arrays.items()}
    path = tmp_path / "y.safetensors"
    tst.save_file(tensors, path, metadata={"format": "pt"})
    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
    assert n % 8 == 0
    back = st_load_file(str(path))
    for k, a in arrays.items():
        np.testing.assert_array_equal(_bits(back[k]), _bits(a), err_msg=k)


def test_reader_refuses_truncated_and_inconsistent_files(tmp_path):
    path = tmp_path / "z.safetensors"
    tst.save_file({"w": torch.arange(64, dtype=torch.float32)}, path)
    raw = path.read_bytes()
    (tmp_path / "short.safetensors").write_bytes(raw[:-4])
    with pytest.raises(ValueError, match="past the end"):
        tst.load_file(tmp_path / "short.safetensors")
    (tmp_path / "tiny.safetensors").write_bytes(raw[:5])
    with pytest.raises(ValueError, match="too short"):
        tst.load_file(tmp_path / "tiny.safetensors")
    n = int.from_bytes(raw[:8], "little")
    header = json.loads(raw[8 : 8 + n])
    header["w"]["shape"] = [65]
    text = json.dumps(header).encode()
    text += b" " * (-len(text) % 8)
    (tmp_path / "bad.safetensors").write_bytes(len(text).to_bytes(8, "little") + text + raw[8 + n :])
    with pytest.raises(ValueError, match="needs"):
        tst.load_file(tmp_path / "bad.safetensors")


# ---- DualAR checkpoints ------------------------------------------------------


def _configs(depthwise_output=True):
    kw = dict(depthwise_output=depthwise_output)
    return jax_tiny(**kw), tiny_debug_config(**kw)


def _legacy_state(jcfg, params, prefix="_orig_mod."):
    """A torch train checkpoint's state dict: split wq/wk/wv, the 3-D
    depthwise head, torch.compile's prefix."""
    state = {k: torch.from_numpy(np.array(v))
             for k, v in jci.state_dict_from_params(params, jcfg).items()}
    dq = jcfg.n_head * jcfg.head_dim
    dkv = jcfg.n_local_heads * jcfg.head_dim
    for key in [k for k in state if k.endswith("attention.wqkv.weight")]:
        w = state.pop(key)
        base = key[: -len("wqkv.weight")]
        state[base + "wq.weight"], state[base + "wk.weight"], state[base + "wv.weight"] = (
            w[:dq].clone(), w[dq : dq + dkv].clone(), w[dq + dkv :].clone())
    if jcfg.depthwise_output:
        state["fast_output.weight"] = torch.from_numpy(np.asarray(params["fast_output"]).copy())
    return {prefix + k: v for k, v in state.items()}


@pytest.mark.parametrize("depthwise_output", [True, False], ids=["depthwise", "flat_head"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_load_params_matches_jax_on_safetensors(tmp_path, depthwise_output, dtype):
    jcfg, cfg = _configs(depthwise_output)
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    params = jax_init(jcfg, jax.random.PRNGKey(3), dtype=jdt)
    jci.save_params(jax.tree.map(np.asarray, params), jcfg, tmp_path)
    ref = jci.load_params(tmp_path, jcfg)
    got = tci.load_params(tmp_path, DualARConfig.from_json_file(tmp_path / "config.json"),
                          device="cpu")
    _assert_same_tree(got, ref)


@pytest.mark.parametrize("depthwise_output", [True, False], ids=["depthwise_3d", "flat_head"])
@pytest.mark.parametrize("wrapped", [True, False], ids=["model_state_dict", "bare"])
def test_load_params_matches_jax_on_legacy_pth(tmp_path, depthwise_output, wrapped):
    jcfg, cfg = _configs(depthwise_output)
    params = jax.tree.map(np.asarray, jax_init(jcfg, jax.random.PRNGKey(4)))
    state = _legacy_state(jcfg, params)
    torch.save({"model_state_dict": state} if wrapped else state, tmp_path / "model.pth")
    ref = jci.load_params(tmp_path, jcfg)
    got = tci.load_params(tmp_path, cfg, device="cpu")
    _assert_same_tree(got, ref)
    _assert_same_tree(got, params)  # the split/prefixed dict round-trips exactly


def test_load_params_casts_to_dtype(tmp_path):
    jcfg, cfg = _configs()
    jci.save_params(jax.tree.map(np.asarray, jax_init(jcfg, jax.random.PRNGKey(5))), jcfg, tmp_path)
    ref = jax.tree.map(np.asarray, jci.load_params(tmp_path, jcfg, dtype=jnp.bfloat16))
    got = tci.load_params(tmp_path, cfg, dtype=torch.bfloat16, device="cpu")
    _assert_same_tree(got, ref)


@pytest.mark.parametrize("depthwise_output", [True, False], ids=["depthwise", "flat_head"])
def test_save_params_loads_in_jax(tmp_path, depthwise_output):
    jcfg, cfg = _configs(depthwise_output)
    params = jax.tree.map(np.asarray, jax_init(jcfg, jax.random.PRNGKey(6)))
    tree = tci.params_from_state_dict(
        {k: torch.from_numpy(np.array(v))
         for k, v in jci.state_dict_from_params(params, jcfg).items()}, cfg)
    tci.save_params(tree, cfg, tmp_path)
    assert json.loads((tmp_path / "config.json").read_text()) == jcfg.model_dump()
    _assert_same_tree(tree, jci.load_params(tmp_path, jcfg))
    _assert_same_tree(tci.load_params(tmp_path, cfg, device="cpu"), params)


# ---- tokenizer ---------------------------------------------------------------

TEXTS = [
    "Hello, world! 123",
    "café naïve ÿ \xa0x",  # latin-1
    "<|speaker:3|>hi<|semantic:5|><|im_end|>",
    "<|im_start|>user\nSay this.<|im_end|>\n<|im_start|>assistant\n",
    "system user assistant",
    "<|foo user|> <|semantic:99|> a<|b",  # not special tokens: text, control words inside
    "日本語 € 😀 ok",  # outside latin-1: dropped by both
]


@pytest.mark.parametrize("codebook_size", [32, 2048])
def test_load_tokenizer_encodes_as_hf(tmp_path, codebook_size):
    jax_save_tokenizer(tmp_path, codebook_size)
    hf = Tokenizer.from_file(str(tmp_path / "tokenizer.json"))
    tok = load_tokenizer(tmp_path)
    assert isinstance(tok, ByteTokenizer) and tok.codebook_size == codebook_size
    for text in TEXTS:
        assert tok.encode(text) == hf.encode(text).ids, text


def test_written_tokenizer_loads_in_hf(tmp_path):
    (tmp_path / "jax").mkdir()
    jax_save_tokenizer(tmp_path / "jax", 64)
    save_byte_level_tokenizer(tmp_path / "port", 64)
    ref = Tokenizer.from_file(str(tmp_path / "jax" / "tokenizer.json"))
    hf = Tokenizer.from_file(str(tmp_path / "port" / "tokenizer.json"))
    assert hf.get_vocab_size() == ref.get_vocab_size() == 256 + 64 + 64
    for text in TEXTS:
        assert hf.encode(text).ids == ref.encode(text).ids, text
    assert isinstance(load_tokenizer(tmp_path / "port"), ByteTokenizer)


def test_tokenizer_without_file_and_non_byte_level(tmp_path):
    tok = load_tokenizer(tmp_path)
    assert isinstance(tok, ByteTokenizer) and tok.codebook_size == 2048
    save_byte_level_tokenizer(tmp_path, 32)
    d = json.loads((tmp_path / "tokenizer.json").read_text())
    d["model"]["merges"] = [["a", "b"]]
    d["model"]["vocab"]["ab"] = 256 + 64 + 32
    (tmp_path / "tokenizer.json").write_text(json.dumps(d))
    # a vocabulary with merges is BPE: the port's BPE tokenizer, HF's ids
    from smoltts_torch.bpe import BPETokenizer

    tok = load_tokenizer(tmp_path)
    assert isinstance(tok, BPETokenizer)
    hf = Tokenizer.from_file(str(tmp_path / "tokenizer.json"))
    for text in ("abc ab", "<|im_start|>user\nab<|im_end|>", "x\u00e9ab"):
        assert tok.encode(text) == hf.encode(text).ids, text
    # a component the port does not read is refused by name
    d["normalizer"] = {"type": "Lowercase"}
    (tmp_path / "tokenizer.json").write_text(json.dumps(d))
    with pytest.raises(NotImplementedError, match="tokenizer.json normalizer 'Lowercase'"):
        load_tokenizer(tmp_path)


# ---- WAV ---------------------------------------------------------------------


def test_wav_bytes_match_jax():
    pcm = (np.sin(np.linspace(0, 100, 4801)) * 1.3).astype(np.float32)
    assert pcm_to_wav_bytes(pcm, 24_000) == jax_wav(pcm, 24_000)
    assert wav_header(24_000) == jax_wav_header(24_000)
    assert len(wav_header(16_000, 2, 100)) == 44
