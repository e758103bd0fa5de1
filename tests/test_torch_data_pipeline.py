"""PyTorch port, the data pipeline (`smoltts_torch/data_pipeline/`) against
the JAX package's on seeded numpy inputs: the prompt encoder (exact), row
tokenization and the causal shift for both tokenizer strategies (exact),
FFD packing under each speaker strategy (same rows, same order), the config
parser against pydantic, `convert_lm_init` (exact), the init dirs read
across both ways, `MimiCodec` encode (codes equal) and decode (1e-4 / 1e-5,
as tests/test_torch_codec_batch.py), both CLIs on a small `datasets` dir,
and the preview's row decode and `/random` route. Small Mimi (HF weights),
tiny LM."""

import json
import threading
import urllib.request
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smoltts_tpu.codec import mimi as jm
from smoltts_tpu.codec.config import MimiConfig as JaxMimiConfig
from smoltts_tpu.config import tiny_debug_config as jax_tiny
from smoltts_tpu.data_pipeline import create_init as jci
from smoltts_tpu.data_pipeline import encode_audio as jea
from smoltts_tpu.data_pipeline import preview as jpv
from smoltts_tpu.data_pipeline import prompt as jpr
from smoltts_tpu.data_pipeline import tokenize_dataset as jtd
from smoltts_tpu.tokenizer import ByteTokenizer as JaxByteTokenizer
from smoltts_torch.codec import mimi as tm
from smoltts_torch.codec.config import MimiConfig
from smoltts_torch.config import tiny_debug_config
from smoltts_torch.data_pipeline import create_init as tci
from smoltts_torch.data_pipeline import encode_audio as tea
from smoltts_torch.data_pipeline import preview as tpv
from smoltts_torch.data_pipeline import prompt as tpr
from smoltts_torch.data_pipeline import tokenize_dataset as ttd
from smoltts_torch.io.checkpoint import load_params
from smoltts_torch.io.safetensors import save_file
from smoltts_torch.tokenizer import ByteTokenizer

ROOT = Path(__file__).resolve().parent.parent
BPE_SPEC = json.loads((ROOT / "tests" / "data" / "torch_bpe_fixture.json")
                      .read_text(encoding="utf-8"))["tokenizer"]
# 16 quantizers, so a 9-row ground_truth grid decodes (1 semantic + 8 acoustic)
SMALL = dict(
    num_filters=8, upsampling_ratios=[4, 3, 2], hidden_size=32, num_hidden_layers=2,
    num_attention_heads=2, head_dim=16, intermediate_size=64, codebook_size=64,
    codebook_dim=16, num_quantizers=16, upsample_groups=32, sampling_rate=24_000,
    frame_rate=500.0,
)
HOP = 48  # 24000 / 500
TOL = dict(rtol=1e-4, atol=1e-5)
TEXTS = ["Hello there!", "It's 3 o'clock, systematic users.", "Größe — naïve café.", ""]


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads: the suite runs several workers on one host."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _tokenizers(strategy):
    """(JAX-side tokenizer, port tokenizer) for a strategy."""
    if strategy == "bytelevel":
        return JaxByteTokenizer(2048), ByteTokenizer(2048)
    from tokenizers import Tokenizer

    from smoltts_torch.bpe import BPETokenizer

    return Tokenizer.from_str(json.dumps(BPE_SPEC)), BPETokenizer(BPE_SPEC)


def _encoders(strategy="bytelevel", **kw):
    jtok, ttok = _tokenizers(strategy)
    return (jpr.PipelinePromptEncoder(jtok, jpr.TokenizationConfig(**kw)),
            tpr.PipelinePromptEncoder(ttok, tpr.TokenizationConfig(**kw)))


# ---- prompt encoder ----------------------------------------------------------


@pytest.mark.parametrize("strategy", ["bytelevel", "bpe"])
@pytest.mark.parametrize("delay,dup", [(0, True), (2, True), (0, False), (2, False)])
def test_prompt_encoder_matches_jax(strategy, delay, dup):
    jenc, tenc = _encoders(strategy, acoustic_delay=delay, duplicate_code_0=dup)
    assert tenc.depth == jenc.depth and tenc.semantic_offset == jenc.semantic_offset
    np.testing.assert_array_equal(tenc.trailing_im_end, jenc.trailing_im_end)
    for text in TEXTS:
        for role, gen in (("user", True), ("system", False), ("assistant", True)):
            np.testing.assert_array_equal(tenc.encode_text_turn(role, text, gen),
                                          jenc.encode_text_turn(role, text, gen))
    codes = np.random.default_rng(delay).integers(0, 2048, (8, 11))
    got, ref = tenc.encode_vq(codes), jenc.encode_vq(codes)
    assert got.dtype == ref.dtype == np.int32
    np.testing.assert_array_equal(got, ref)
    if dup:
        got = tenc.encode_vq_corrupt(codes, dropout=0.4, rng=np.random.default_rng(7))
        np.testing.assert_array_equal(got, jenc.encode_vq_corrupt(
            codes, dropout=0.4, rng=np.random.default_rng(7)))
    else:  # the corrupted block keeps code 0 twice: both refuse a depth of 7
        for enc in (tenc, jenc):
            with pytest.raises(ValueError):
                enc.encode_vq_corrupt(codes, rng=np.random.default_rng(7))
    for bad in (codes[0], codes[None]):
        with pytest.raises(ValueError):
            tenc.encode_vq(bad)


# ---- config ------------------------------------------------------------------


def _cfg(module, strategy="bytelevel", speaker="id_token", max_len=96, **extra):
    d = {"tokenization": {"tokenizer_path": "unused", "strategy": strategy},
         "speaker": {"strategy": speaker, "speaker_names": ["alice", "bob", "cy"],
                     "default_sysprompt": "Read this aloud." if speaker == "fixed" else None},
         "audio": {"frame_rate": 12.5, "max_sample_secs": 15.0},
         "packing": {"max_sequence_length": max_len, "window_size": 5}, **extra}
    return module.PipelineConfig(**d) if module is jtd else ttd.PipelineConfig.from_dict(d)


def _pydantic_or_error(d):
    try:
        return jtd.PipelineConfig(**d).model_dump(), None
    except Exception as e:  # pydantic.ValidationError
        return None, e


def _same_as_pydantic(d):
    ref, err = _pydantic_or_error(d)
    if err is not None:
        with pytest.raises(ValueError):
            ttd.PipelineConfig.from_dict(d)
        return
    got = ttd.PipelineConfig.from_dict(d)
    import dataclasses

    assert dataclasses.asdict(got) == ref


@pytest.mark.parametrize("path", sorted((ROOT / "config" / "pipeline").glob("*.json")),
                         ids=lambda p: p.name)
def test_config_files_parse_as_pydantic(path):
    d = json.loads(path.read_text())
    _same_as_pydantic(d)
    assert ttd.PipelineConfig.from_json(path).tokenization.strategy == "bytelevel"


BASE = {"tokenization": {"tokenizer_path": "x", "strategy": "bytelevel"},
        "speaker": {"strategy": "omit"}, "audio": {}}


def _edit(path, value):
    d = json.loads(json.dumps(BASE))
    node = d
    for k in path[:-1]:
        node = node.setdefault(k, {})
    if value is KeyError:
        node.pop(path[-1])
    else:
        node[path[-1]] = value
    return d


@pytest.mark.parametrize("edit", [
    (("tokenization", "strategy"), "wordpiece"),
    (("speaker", "strategy"), "random"),
    (("tokenization",), KeyError),
    (("speaker",), KeyError),
    (("audio",), KeyError),
    (("audio",), None),
    (("packing",), None),
    (("tokenization", "tokenizer_path"), KeyError),
    (("tokenization", "tokenizer_path"), 5),
    (("tokenization", "duplicate_code_0"), "no"),
    (("tokenization", "duplicate_code_0"), 2),
    (("tokenization", "duplicate_code_0"), None),
    (("audio", "frame_rate"), 25),
    (("audio", "frame_rate"), "12.5"),
    (("audio", "frame_rate"), "fast"),
    (("packing", "max_sequence_length"), "512"),
    (("packing", "max_sequence_length"), 512.0),
    (("packing", "max_sequence_length"), 512.5),
    (("packing", "max_items_per_pack"), True),
    (("speaker", "speaker_names"), "alice"),
    (("speaker", "speaker_names"), ["alice", 3]),
    (("speaker", "default_sysprompt"), "Be calm."),
    (("unknown_section",), {"a": 1}),
    (("audio", "unknown_key"), 3),
    (("dataset_id",), 7),
], ids=lambda e: f"{'.'.join(e[0])}={e[1]!r}")
def test_config_parser_accepts_and_rejects_as_pydantic(edit):
    _same_as_pydantic(_edit(*edit))


def test_config_defaults_equal_pydantic():
    import dataclasses

    assert dataclasses.asdict(ttd.PipelineConfig.from_dict(BASE)) == \
        jtd.PipelineConfig(**BASE).model_dump()
    assert dataclasses.asdict(ttd.PackingStrategy()) == jtd.PackingStrategy().model_dump()
    assert dataclasses.asdict(ttd.AudioConfig()) == jtd.AudioConfig().model_dump()
    assert dataclasses.asdict(tpr.TokenizationConfig()) == jpr.TokenizationConfig().model_dump()


# ---- rows, shift, packing ----------------------------------------------------


@pytest.mark.parametrize("strategy", ["bytelevel", "bpe"])
def test_tokenize_row_and_causal_shift_match_jax(strategy):
    jenc, tenc = _encoders(strategy)
    jcfg, tcfg = _cfg(jtd, strategy), _cfg(ttd, strategy)
    rng = np.random.default_rng(1)
    for text in TEXTS:
        row = {"text_normalized": text, "codes": rng.integers(0, 2048, (8, 5))}
        got, ref = ttd.tts_tokenize_row(row, tenc, tcfg), jtd.tts_tokenize_row(row, jenc, jcfg)
        np.testing.assert_array_equal(got["ground_truth"], ref["ground_truth"])
        gs, rs = ttd.causal_shift_row(got), jtd.causal_shift_row(ref)
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(gs[k], rs[k])


def _utterances(n=23, seed=2):
    rng = np.random.default_rng(seed)
    return {"speaker_id": [["alice", "bob", "cy"][int(i)] for i in rng.integers(0, 3, n)],
            "ground_truth": [rng.integers(0, 3000, (9, int(rng.integers(4, 40))))
                             .astype(np.int32) for _ in range(n)]}


@pytest.mark.parametrize("speaker", ["id_token", "fixed", "omit"])
def test_pack_utterances_matches_jax(speaker):
    jenc, tenc = _encoders()
    jcfg, tcfg = _cfg(jtd, speaker=speaker), _cfg(ttd, speaker=speaker)
    batch = _utterances()
    ref = jtd.pack_utterances(batch, jtd.SyspromptEncoder(jcfg, jenc))
    got = ttd.pack_utterances(batch, ttd.SyspromptEncoder(tcfg, tenc))
    assert got["speaker_id"] == ref["speaker_id"]
    assert len(got["ground_truth"]) == len(ref["ground_truth"]) < len(batch["ground_truth"])
    for a, b in zip(got["ground_truth"], ref["ground_truth"]):
        np.testing.assert_array_equal(a, b)


def test_sysprompt_without_names_raises_as_jax():
    _, tenc = _encoders()
    cfg = ttd.PipelineConfig.from_dict(_edit(("speaker", "strategy"), "id_token"))
    with pytest.raises(ValueError, match="requires"):
        ttd.SyspromptEncoder(cfg, tenc).add_sysprompt(np.zeros((9, 2), np.int32), "x")


# ---- model inits ---------------------------------------------------------------


@pytest.mark.parametrize("tied", [True, False])
def test_convert_lm_init_matches_jax(tied):
    cfg = tiny_debug_config(codebook_size=32, vocab_size=256 + 64 + 32, tie_word_embeddings=tied)
    jcfg = jax_tiny(codebook_size=32, vocab_size=256 + 64 + 32, tie_word_embeddings=tied)
    rng = np.random.default_rng(0)
    D, FF, V0, KV = cfg.dim, cfg.intermediate_size, 300, cfg.dim // 2
    hf = {"model.embed_tokens.weight": rng.standard_normal((V0, D)).astype(np.float32),
          "model.norm.weight": rng.standard_normal(D).astype(np.float32),
          "lm_head.weight": rng.standard_normal((V0, D)).astype(np.float32)}
    shapes = {"self_attn.q_proj.weight": (D, D), "self_attn.k_proj.weight": (KV, D),
              "self_attn.v_proj.weight": (KV, D), "self_attn.o_proj.weight": (D, D),
              "mlp.gate_proj.weight": (FF, D), "mlp.down_proj.weight": (D, FF),
              "mlp.up_proj.weight": (FF, D), "input_layernorm.weight": (D,),
              "post_attention_layernorm.weight": (D,)}
    for i in range(cfg.n_layer):
        for k, s in shapes.items():
            hf[f"model.layers.{i}.{k}"] = rng.standard_normal(s).astype(np.float32)
    got = tci.convert_lm_init(hf, cfg, cfg.n_layer)
    ref = jci.convert_lm_init(hf, jcfg, jcfg.n_layer)
    assert sorted(got) == sorted(ref) and ("output.weight" in got) == (not tied)
    for k in ref:
        assert got[k].dtype == ref[k].dtype
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def _trees_equal(a, b, path=""):
    if isinstance(b, dict):
        assert set(a) == set(b), path
        for k in b:
            _trees_equal(a[k], b[k], f"{path}.{k}")
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=path)


def test_create_bytelevel_init_read_across(tmp_path):
    from smoltts_tpu.config import DualARConfig as JaxDualARConfig
    from smoltts_tpu.io.checkpoint_interop import load_params as jax_load_params
    from smoltts_tpu.models.dual_ar import init_params as jax_init
    from smoltts_tpu.tokenizer import load_tokenizer as jax_load_tokenizer
    from smoltts_torch.config import DualARConfig
    from smoltts_torch.models.dual_ar import init_params
    from smoltts_torch.tokenizer import load_tokenizer

    kw = dict(codebook_size=32, vocab_size=256 + 64 + 32)
    cfg, jcfg = tiny_debug_config(**kw), jax_tiny(**kw)
    tci.create_bytelevel_init(tmp_path / "port", cfg, seed=3, device="cpu")
    jci.create_bytelevel_init(str(tmp_path / "jax"), jcfg, seed=3)
    for d in ("port", "jax"):
        assert sorted(p.name for p in (tmp_path / d).iterdir()) == \
            ["config.json", "model.safetensors", "tokenizer.json"]
        assert json.loads((tmp_path / d / "config.json").read_text()) == \
            json.loads((tmp_path / "jax" / "config.json").read_text())
        assert (tmp_path / d / "tokenizer.json").read_bytes() == \
            (tmp_path / "jax" / "tokenizer.json").read_bytes()
    # the port's dir in the JAX package: its params, its tokenizer
    mine = init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    _trees_equal(jax_load_params(tmp_path / "port", JaxDualARConfig.from_json_file(
        tmp_path / "port" / "config.json")), {k: v for k, v in mine.items()})
    text = "<|im_start|>user\nHi ü<|im_end|>"
    assert jax_load_tokenizer(tmp_path / "port").encode(text).ids == \
        load_tokenizer(tmp_path / "port").encode(text)
    # the JAX dir in the port
    ref = jax.tree.map(np.asarray, jax_init(jcfg, jax.random.PRNGKey(3)))
    got = load_params(tmp_path / "jax", DualARConfig.from_json_file(tmp_path / "jax"),
                      device="cpu")
    _trees_equal(got, ref)
    # no weights: tokenizer + config only
    tci.create_bytelevel_init(tmp_path / "nw", cfg, save_weights=False, device="cpu")
    assert sorted(p.name for p in (tmp_path / "nw").iterdir()) == ["config.json", "tokenizer.json"]
    tci.main(["-o", str(tmp_path / "cli"), "--size", "70m", "--no-weights", "--device", "cpu"])
    from smoltts_torch.config import smoltts_byte_70m

    assert DualARConfig.from_json_file(tmp_path / "cli") == smoltts_byte_70m()


# ---- the codec -------------------------------------------------------------


@pytest.fixture(scope="module")
def mimi(tmp_path_factory):
    """(HF state as torch tensors, JAX tree, port tree, JAX cfg, port cfg,
    safetensors path), one random HF MimiModel as test_torch_codec_batch.py
    builds it."""
    from transformers import MimiConfig as HFConfig
    from transformers import MimiModel

    jcfg, cfg = JaxMimiConfig(**SMALL), MimiConfig(**SMALL)
    torch.manual_seed(0)
    hf = MimiModel(HFConfig(
        num_filters=cfg.num_filters, upsampling_ratios=cfg.upsampling_ratios,
        hidden_size=cfg.hidden_size, num_hidden_layers=cfg.num_hidden_layers,
        num_attention_heads=cfg.num_attention_heads, num_key_value_heads=cfg.num_attention_heads,
        head_dim=cfg.head_dim, intermediate_size=cfg.intermediate_size,
        codebook_size=cfg.codebook_size, codebook_dim=cfg.codebook_dim,
        vector_quantization_hidden_dimension=cfg.codebook_dim,
        num_quantizers=cfg.num_quantizers, num_semantic_quantizers=cfg.num_semantic_quantizers,
        upsample_groups=cfg.upsample_groups, sampling_rate=cfg.sampling_rate,
        frame_rate=cfg.frame_rate, sliding_window=cfg.sliding_window)).eval()
    sd = hf.state_dict()
    g = torch.Generator().manual_seed(1)
    for k in list(sd):
        if k.endswith("codebook.embed_sum"):
            sd[k] = torch.randn(sd[k].shape, generator=g)
        elif k.endswith("codebook.cluster_usage"):
            sd[k] = torch.rand(sd[k].shape, generator=g) + 0.5
    state = {k: v.float().contiguous() for k, v in sd.items()}
    path = tmp_path_factory.mktemp("mimi") / "mimi.safetensors"
    save_file(state, path)
    jparams = jm.params_from_hf_state_dict({k: v.numpy() for k, v in state.items()}, jcfg)
    params = tm.params_from_hf_state_dict(state, cfg)
    return jparams, params, jcfg, cfg, path


def _audio(lens, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(n) * 0.3).astype(np.float32) for n in lens]


def _codecs(mimi):
    jparams, params, jcfg, cfg, _ = mimi
    return (jea.MimiCodec(jparams, jcfg, num_codebooks=8),
            tea.MimiCodec(params, cfg, num_codebooks=8, device="cpu"))


@pytest.mark.parametrize("bucket", [1, 4])
def test_mimi_codec_encode_batch_codes_equal_jax(mimi, bucket):
    jc, tc = _codecs(mimi)
    audios = _audio([HOP * 5 + 17, HOP * 2, 1, HOP * 9 - 1, HOP * 3 + 1])
    got, ref = tc.encode_batch(audios, bucket_multiple=bucket), \
        jc.encode_batch(audios, bucket_multiple=bucket)
    assert [g.shape for g in got] == [(8, 6), (8, 2), (8, 1), (8, 9), (8, 4)]
    for a, b in zip(got, ref):
        assert a.dtype == np.int32
        np.testing.assert_array_equal(a, np.asarray(b))
    np.testing.assert_array_equal(tc.encode(audios[0]), np.asarray(jc.encode(audios[0])))


@pytest.mark.parametrize("T", [1, 6])
def test_mimi_codec_decode_matches_jax(mimi, T):
    jc, tc = _codecs(mimi)
    codes = np.random.default_rng(T).integers(0, 64, (8, T)).astype(np.int32)
    got, ref = tc.decode(codes), np.asarray(jc.decode(codes))
    assert got.shape == ref.shape == (T * HOP,) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, **TOL)


def test_encode_dataset_rows_matches_jax(mimi):
    jc, tc = _codecs(mimi)
    audios = _audio([HOP * 3, HOP * 4 + 5, HOP, 77, HOP * 2])
    rows = [{"audio": {"array": a, "sampling_rate": 24000} if i % 2 else a, "id": i}
            for i, a in enumerate(audios)]
    got = tea.encode_dataset_rows(tc, rows, batch_size=2)
    ref = jea.encode_dataset_rows(jc, rows, batch_size=2)
    assert [sorted(r) for r in got] == [["codes", "id"]] * 5
    for a, b in zip(got, ref):
        assert a["id"] == b["id"]
        np.testing.assert_array_equal(a["codes"], np.asarray(b["codes"]))


# ---- the CLIs on a small datasets dir ------------------------------------------


def _load_rows(path):
    from datasets import load_from_disk

    ds = load_from_disk(str(path))
    ds = ds["train"] if hasattr(ds, "keys") and "train" in ds else ds
    return [ds[i] for i in range(len(ds))]


def test_encode_audio_main_matches_jax(mimi, tmp_path, monkeypatch):
    from datasets import Dataset

    import smoltts_tpu.codec.mimi as jmimi
    import smoltts_torch.codec.mimi as tmimi

    *_, jcfg, cfg, path = mimi
    real_j, real_t = jmimi.load_mimi, tmimi.load_mimi
    monkeypatch.setattr(jmimi, "load_mimi", lambda p, c=None, **kw: real_j(p, jcfg, **kw))
    monkeypatch.setattr(tmimi, "load_mimi", lambda p, c=None, **kw: real_t(p, cfg, **kw))
    audios = _audio([HOP * 3 + 2, HOP * 5, HOP * 2 + 30, HOP * 4, 50, HOP * 6], seed=5)
    Dataset.from_dict({"audio": [a.tolist() for a in audios],
                       "text": [f"utt {i}" for i in range(6)]}).save_to_disk(str(tmp_path / "in"))
    common = ["--dataset-path", str(tmp_path / "in"), "--mimi-path", str(path),
              "--batch-size", "4", "--shards", "2"]
    jea.main(common + ["--out-path", str(tmp_path / "jax")])
    tea.main(common + ["--out-path", str(tmp_path / "port"), "--device", "cpu"])
    # resume: the first shard is skipped
    tea.main(common + ["--out-path", str(tmp_path / "resumed"), "--device", "cpu",
                       "--skip-shards", "1"])
    assert not (tmp_path / "resumed_shard000").exists()
    for shard in ("_shard000", "_shard001"):
        got, ref = _load_rows(str(tmp_path / "port") + shard), _load_rows(str(tmp_path / "jax") + shard)
        assert got == ref and len(got) == 3
    assert _load_rows(str(tmp_path / "resumed_shard001")) == _load_rows(str(tmp_path / "jax_shard001"))


def _codes_dataset(tmp_path, n=14, seed=3):
    from datasets import Dataset, DatasetDict

    rng = np.random.default_rng(seed)
    rows = {"text": [f"Line {i}: it's {int(rng.integers(0, 99))} o'clock, naïve." for i in range(n)],
            "speaker": [["alice", "bob", "cy"][int(i)] for i in rng.integers(0, 3, n)],
            "codes": [rng.integers(0, 2048, (8, int(rng.integers(3, 30)))).tolist()
                      for _ in range(n)]}
    DatasetDict({"train": Dataset.from_dict(rows)}).save_to_disk(str(tmp_path / "codes"))
    return tmp_path / "codes"


@pytest.mark.parametrize("strategy", ["bytelevel", "bpe"])
def test_tokenize_dataset_main_matches_jax(tmp_path, strategy):
    from smoltts_torch.tokenizer import save_byte_level_tokenizer

    tok_dir = tmp_path / "tok"
    if strategy == "bytelevel":
        save_byte_level_tokenizer(tok_dir)
    else:
        tok_dir.mkdir()
        (tok_dir / "tokenizer.json").write_text(json.dumps(BPE_SPEC), encoding="utf-8")
    cfg = {"dataset_path": str(_codes_dataset(tmp_path)),
           "tokenization": {"tokenizer_path": str(tok_dir), "strategy": strategy},
           "speaker": {"strategy": "id_token", "speaker_names": ["alice", "bob", "cy"]},
           "audio": {"frame_rate": 1.0, "max_sample_secs": 25.0},
           "packing": {"max_sequence_length": 160, "window_size": 6}}
    (tmp_path / "cfg.json").write_text(json.dumps(cfg))
    args = ["-c", str(tmp_path / "cfg.json"), "--num-proc", "0", "--shards", "2"]
    jtd.main(args + ["-o", str(tmp_path / "jax")])
    ttd.main(args + ["-o", str(tmp_path / "port")])
    got, ref = _load_rows(tmp_path / "port"), _load_rows(tmp_path / "jax")
    assert got == ref and 0 < len(got) < 14
    # the list path is main's in one process and one shard
    ref1 = tmp_path / "jax1"
    jtd.main(["-c", str(tmp_path / "cfg.json"), "--num-proc", "0", "-o", str(ref1)])
    pcfg = ttd.PipelineConfig.from_dict(cfg)
    enc = tpr.PipelinePromptEncoder(ttd._load_tokenizer(str(tok_dir)), tpr.TokenizationConfig())
    rows = [dict(r, text_normalized=r.pop("text"), speaker_id=r.pop("speaker"))
            for r in _load_rows(tmp_path / "codes")]
    listed = ttd.process_rows(rows, pcfg, enc, ttd.SyspromptEncoder(pcfg, enc))
    assert [{k: np.asarray(v).tolist() for k, v in r.items()} for r in listed] == \
        _load_rows(ref1)


# ---- preview -----------------------------------------------------------------


def test_preview_decode_row_matches_jax(mimi):
    """A `codes` row decodes as JAX's; a `ground_truth` row (text ids and
    semantic ids past the codebook in row 0) gives JAX's PCM too, because the
    preview clamps ids as JAX's gather does. Unclamped, the port's decoder
    refuses such ids."""
    import io
    import wave

    jc, tc = _codecs(mimi)
    enc = tpr.PipelinePromptEncoder(ByteTokenizer(2048), tpr.TokenizationConfig())
    cfg = _cfg(ttd, speaker="omit")
    codes = np.random.default_rng(4).integers(0, 64, (8, 5)).astype(np.int32)
    gt = ttd.tts_tokenize_row({"text_normalized": "Hi.", "codes": codes}, enc, cfg)["ground_truth"]
    assert gt.shape[0] == 9 and gt.max() >= 64
    with pytest.raises(IndexError):
        tc.decode(gt)

    def pcm(wav):
        with wave.open(io.BytesIO(wav)) as w:
            assert w.getframerate() == 24_000 and w.getsampwidth() == 2
            return np.frombuffer(w.readframes(w.getnframes()), np.int16).astype(np.int32)

    for row in ({"codes": codes}, {"ground_truth": gt, "speaker_id": "x"}):
        got, ref = pcm(tpv._decode_row(tc, row)), pcm(jpv._decode_row(jc, row))
        n = next(iter(row.values())).shape[-1] * HOP
        assert got.shape == ref.shape == (n,)
        assert np.abs(got - ref).max() <= 1  # PCM within 1e-5, rounded to int16
    ids = np.array([-1, -64, -65, -3000, 0, 63, 64, 2367], np.int32)
    np.testing.assert_array_equal(tpv.clamp_codes(ids, 64),
                                  np.asarray(jnp.arange(64)[jnp.asarray(ids)]))


def test_preview_serves_random_rows(mimi, monkeypatch):
    from smoltts_torch.server.http import HttpServer

    _, tc = _codecs(mimi)
    rng = np.random.default_rng(5)
    dataset = [{"codes": rng.integers(0, 64, (8, 4)).astype(np.int32)} for _ in range(3)]
    started = []
    real_run = HttpServer.run
    monkeypatch.setattr(HttpServer, "run", lambda self, host, port: (
        started.append(self), real_run(self, host, port)))
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    th = threading.Thread(target=tpv.serve_preview, args=(dataset, tc, "127.0.0.1", port),
                          daemon=True)
    th.start()
    try:
        body = None
        for _ in range(200):
            try:
                with urllib.request.urlopen(f"http://127.0.0.1:{port}/random", timeout=30) as r:
                    body, ctype = r.read(), r.headers["content-type"]
                break
            except OSError:
                th.join(0.05)
        assert body is not None and ctype == "audio/wav"
        assert body[:4] == b"RIFF" and len(body) == 44 + 4 * HOP * 2
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/", timeout=30) as r:
            assert b'src="/random"' in r.read()
    finally:
        started[0].stop()
        th.join(timeout=30)
    assert not th.is_alive()
