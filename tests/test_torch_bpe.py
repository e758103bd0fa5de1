"""PyTorch port, the JSON-only BPE tokenizer (`smoltts_torch/bpe.py`)
against HF `tokenizers`: the checked-in fixture (a byte-level BPE with
SmolLM2's pre-tokenizer and the smoltts special tokens, written by
scripts/torch_bpe_fixture.py) and variants of it, on the fixture's strings
and on hypothesis strings; round trips, refused components, the dispatch of
`load_tokenizer`, and the port's and the JAX package's `SmolTTS` on a tiny
BPE checkpoint."""

import copy
import json
import unicodedata
from pathlib import Path

import jax
import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st
from tokenizers import Tokenizer

from smoltts_torch.bpe import BPETokenizer, gpt2_split
from smoltts_torch.tokenizer import (
    ByteTokenizer, byte_level_tokenizer_json, load_tokenizer, special_token_list,
)
from tests import torch_threads  # noqa: F401  (one intra-op thread)

FIXTURE = Path(__file__).parent / "data" / "torch_bpe_fixture.json"
SPEC = json.loads(FIXTURE.read_text(encoding="utf-8"))
CASES = SPEC["cases"]
HYPO = settings(max_examples=150, deadline=None,
                suppress_health_check=[HealthCheck.too_slow, HealthCheck.function_scoped_fixture])

# characters assigned in this Python's Unicode tables (HF's Rust tables may
# be newer; see smoltts_torch/bpe.py)
CHARS = st.characters(exclude_categories=("Cn", "Cs"))
PIECES = st.sampled_from([
    " ", "  ", "\t", "\n", "\r\n", "\xa0", "\u3000", "\x1c", "\x85", "'s", "'t", "'re", "'ve",
    "'m", "'ll", "'d", "'S", "''", "0", "12", "345", "\u0663", "\xbd", "\u2167", "system",
    "user", "assistant", "<|im_start|>", "<|im_end|>", "<|semantic:7|>", "<|speaker:2|>",
    "<|pad|>", "<|", "|>", "Hello", " world", "\xe9", "e\u0301", "\ufb01", "\u24b6", "_",
    "\u200d", "\U0001f600", "word", " word ", "<mask>", "[sep]", " both ", "fix", "\ufb01x",
    "raw\xe9", "hello world",
])
TEXT = st.lists(st.one_of(st.text(CHARS, max_size=6), PIECES), max_size=12).map("".join)


def hf_of(spec: dict) -> Tokenizer:
    return Tokenizer.from_str(json.dumps(spec))


def _fixture(**model):
    spec = copy.deepcopy(SPEC["tokenizer"])
    spec["model"].update(model)
    return spec


def _with(spec, **top):
    spec = copy.deepcopy(spec)
    spec.update(top)
    return spec


def _byte_level(add_prefix_space, use_regex):
    return {"type": "ByteLevel", "add_prefix_space": add_prefix_space, "trim_offsets": True,
            "use_regex": use_regex}


def _added_flags():
    """The fixture plus non-special added tokens with every flag."""
    spec = copy.deepcopy(SPEC["tokenizer"])
    nxt = max(t["id"] for t in spec["added_tokens"]) + 1
    flags = [("word", dict(single_word=True)), ("<mask>", dict(lstrip=True)),
             ("[sep]", dict(rstrip=True)), ("both", dict(lstrip=True, rstrip=True)),
             ("\ufb01x", dict(normalized=True)), ("raw\xe9", dict(normalized=False)),
             ("hello world", dict(single_word=True, normalized=True))]
    for i, (content, kw) in enumerate(flags):
        spec["added_tokens"].append({"id": nxt + i, "content": content, "single_word": False,
                                     "lstrip": False, "rstrip": False, "normalized": True,
                                     "special": False, **kw})
    spec["normalizer"] = {"type": "NFKC"}
    return spec


def _missing_byte():
    """A vocab without the symbols of bytes 0xC3 and '~', no unk token:
    HF drops such characters."""
    spec = copy.deepcopy(SPEC["tokenizer"])
    gone = {"Ã", "~"}
    spec["model"]["vocab"] = {t: i for t, i in spec["model"]["vocab"].items()
                              if not any(c in gone for c in t)}
    spec["model"]["merges"] = [m for m in spec["model"]["merges"]
                               if not any(c in gone for c in "".join(m))]
    return spec


def _added_ids_reassigned():
    """Added tokens whose file ids are not the ones HF gives them: shifted,
    in reverse order, one with an id inside the vocab."""
    spec = copy.deepcopy(SPEC["tokenizer"])
    added = spec["added_tokens"]
    for t in added:
        t["id"] += 100
    added[5]["special"] = False
    spec["added_tokens"] = added[::-1][:80] + [dict(added[0], content="zz9", id=7)]
    return spec


def _char_model(**model):
    """A character BPE with no pre-tokenizer: lower-case ASCII letters, a
    few merges, an unk token and byte-fallback tokens."""
    vocab = {"<unk>": 0, **{f"<0x{b:02X}>": 1 + b for b in range(256)}}
    for c in "abcdefghijklmnopqrstuvwxyz ":
        vocab[c] = len(vocab)
    merges = [("t", "h"), ("th", "e"), ("e", " "), ("a", "n"), ("an", "d"), ("i", "n")]
    for a, b in merges:
        vocab.setdefault(a + b, len(vocab))
    m = {"type": "BPE", "dropout": None, "unk_token": None, "continuing_subword_prefix": None,
         "end_of_word_suffix": None, "fuse_unk": False, "byte_fallback": False,
         "ignore_merges": False, "vocab": vocab, "merges": [list(p) for p in merges]}
    m.update(model)
    return {"version": "1.0", "truncation": None, "padding": None, "added_tokens": [],
            "normalizer": None, "pre_tokenizer": None, "post_processor": None,
            "decoder": None, "model": m}


def _prefix_suffix():
    """Continuing-subword prefix and end-of-word suffix, as trained by HF."""
    from tokenizers import models, pre_tokenizers, trainers

    tok = Tokenizer(models.BPE(unk_token="[UNK]", continuing_subword_prefix="##",
                               end_of_word_suffix="</w>"))
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=True)
    trainer = trainers.BpeTrainer(vocab_size=300, special_tokens=["[UNK]"],
                                  continuing_subword_prefix="##", end_of_word_suffix="</w>",
                                  show_progress=False, limit_alphabet=60)
    tok.train_from_iterator([c["text"] for c in CASES] * 3, trainer)
    return json.loads(tok.to_str())


VARIANTS = {
    "fixture": lambda: SPEC["tokenizer"],
    "string_merges": lambda: _fixture(merges=[" ".join(m) for m in SPEC["tokenizer"]["model"]["merges"]]),
    "ignore_merges": lambda: _fixture(ignore_merges=True),
    "prefix_space_no_regex": lambda: _with(SPEC["tokenizer"], pre_tokenizer=_byte_level(True, False)),
    "prefix_space_regex": lambda: _with(SPEC["tokenizer"], pre_tokenizer={
        "type": "Sequence", "pretokenizers": [{"type": "Digits", "individual_digits": False},
                                              _byte_level(True, True)]}),
    "nfc_sequence": lambda: _with(SPEC["tokenizer"], normalizer={
        "type": "Sequence", "normalizers": [{"type": "NFC"}, {"type": "NFKC"}]}),
    "added_token_flags": _added_flags,
    "missing_byte_symbol": _missing_byte,
    "added_ids_reassigned": _added_ids_reassigned,
    "unk_fused": lambda: _char_model(unk_token="<unk>", fuse_unk=True),
    "unk_unfused": lambda: _char_model(unk_token="<unk>"),
    "byte_fallback": lambda: _char_model(unk_token="<unk>", byte_fallback=True),
    "no_unk": lambda: _char_model(),
    "prefix_suffix": _prefix_suffix,
    "byte_level_vocab": lambda: byte_level_tokenizer_json(64),
}


@pytest.fixture(scope="module")
def fixture_pair():
    return BPETokenizer(SPEC["tokenizer"]), hf_of(SPEC["tokenizer"])


def test_fixture_ids_are_still_hf_ids(fixture_pair):
    _, hf = fixture_pair
    assert len(CASES) >= 190 and len(SPEC["tokenizer"]["model"]["merges"]) >= 1000
    pre = SPEC["tokenizer"]["pre_tokenizer"]
    assert [p["type"] for p in pre["pretokenizers"]] == ["Digits", "ByteLevel"]
    assert sorted(t["content"] for t in SPEC["tokenizer"]["added_tokens"]) == \
        sorted(special_token_list(2048))
    for case in CASES:
        assert hf.encode(case["text"]).ids == case["ids"], case["text"]


def test_port_gives_the_fixture_ids_and_hf_decode(fixture_pair):
    port, hf = fixture_pair
    for case in CASES:
        assert port.encode(case["text"]) == case["ids"], case["text"]
        for skip in (False, True):
            assert port.decode(case["ids"], skip_special_tokens=skip) == \
                hf.decode(case["ids"], skip_special_tokens=skip)
    assert port.vocab_size == hf.get_vocab_size()
    for tok in ("<|im_end|>", "<|semantic:0|>", "Ġthe", "e", "nope"):
        assert port.token_to_id(tok) == hf.token_to_id(tok)
    for i in (0, 300, 1799, 1800, 3911, 10**6):
        assert port.id_to_token(i) == hf.id_to_token(i)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_variant_matches_hf_on_hypothesis_strings(variant):
    spec = VARIANTS[variant]()
    port, hf = BPETokenizer(spec), hf_of(spec)
    assert port.vocab_size == hf.get_vocab_size()

    @HYPO
    @given(TEXT)
    def check(text):
        ids = hf.encode(text).ids
        assert port.encode(text) == ids
        assert port.decode(ids) == hf.decode(ids, skip_special_tokens=False)

    for case in CASES:
        assert port.encode(case["text"]) == hf.encode(case["text"]).ids, case["text"]
    check()


@HYPO
@given(TEXT)
def test_round_trip(text):
    port = BPETokenizer(SPEC["tokenizer"])
    assert port.decode(port.encode(text)) == text


@HYPO
@given(st.text(st.characters(codec="latin-1"), max_size=40) | TEXT)
def test_bpe_on_the_byte_level_file_equals_byte_tokenizer(text):
    port = BPETokenizer(byte_level_tokenizer_json(2048))
    assert port.encode(text) == ByteTokenizer(2048).encode(text)


def test_gpt2_split_examples():
    assert gpt2_split("Hello world's  12 \t\tx!!  ") == [
        "Hello", " world", "'s", " ", " 12", " \t", "\t", "x", "!!", "  "]
    assert gpt2_split("a\x1cb") == ["a", "\x1c", "b"]  # U+001C is not White_Space
    assert gpt2_split("a\xa0 b") == ["a", "\xa0", " b"]


@pytest.mark.parametrize("where,value,name", [
    ("normalizer", {"type": "Lowercase"}, "Lowercase"),
    ("normalizer", {"type": "Sequence", "normalizers": [{"type": "NFD"}]}, "NFD"),
    ("pre_tokenizer", {"type": "Whitespace"}, "Whitespace"),
    ("pre_tokenizer", {"type": "Sequence", "pretokenizers": [{"type": "Metaspace"}]}, "Metaspace"),
    ("decoder", {"type": "WordPiece"}, "WordPiece"),
    ("post_processor", {"type": "TemplateProcessing"}, "TemplateProcessing"),
    ("model", {"type": "WordPiece", "vocab": {}}, "WordPiece"),
    ("truncation", {"max_length": 8}, "truncation"),
    ("padding", {"length": 8}, "padding"),
])
def test_unsupported_component_is_named(where, value, name):
    spec = _with(SPEC["tokenizer"], **{where: value})
    with pytest.raises(NotImplementedError, match=name):
        BPETokenizer(spec)


def test_dropout_and_bad_merges_are_refused():
    with pytest.raises(NotImplementedError, match="dropout"):
        BPETokenizer(_fixture(dropout=0.1))
    with pytest.raises(ValueError, match="merge"):
        BPETokenizer(_fixture(merges=["a b c"]))
    with pytest.raises(ValueError, match="not in the vocab"):
        BPETokenizer(_fixture(merges=[["zzzq", "e"]]))


def test_load_tokenizer_dispatch(tmp_path):
    assert type(load_tokenizer(tmp_path)) is ByteTokenizer  # no tokenizer.json
    (tmp_path / "tokenizer.json").write_text(json.dumps(byte_level_tokenizer_json(64)))
    tok = load_tokenizer(tmp_path)
    assert type(tok) is ByteTokenizer and tok.codebook_size == 64
    (tmp_path / "tokenizer.json").write_text(json.dumps(SPEC["tokenizer"]), encoding="utf-8")
    tok = load_tokenizer(tmp_path)
    assert isinstance(tok, BPETokenizer)
    assert [tok.encode(c["text"]) for c in CASES] == [c["ids"] for c in CASES]
    # a byte-level vocabulary whose special tokens are not the smoltts layout
    odd = byte_level_tokenizer_json(64)
    odd["added_tokens"] = odd["added_tokens"][:10]
    (tmp_path / "tokenizer.json").write_text(json.dumps(odd))
    tok = load_tokenizer(tmp_path)
    assert isinstance(tok, BPETokenizer)
    assert tok.encode("<|im_start|>hi ü€") == hf_of(odd).encode("<|im_start|>hi ü€").ids
    (tmp_path / "tokenizer.json").write_text(json.dumps(_with(SPEC["tokenizer"], normalizer={
        "type": "Lowercase"})))
    with pytest.raises(NotImplementedError, match="Lowercase"):
        load_tokenizer(tmp_path)


# ---- SmolTTS on a tiny BPE checkpoint, against the JAX package -------------

CB = 32


@pytest.fixture(scope="module")
def bpe_ckpt(tmp_path_factory):
    """Tiny config over the fixture's BPE vocabulary with the smoltts
    special tokens of a 32-entry codebook after it; weights by the JAX
    package, tokenizer.json by HF `tokenizers`."""
    from smoltts_tpu.config import tiny_debug_config as jax_tiny
    from smoltts_tpu.io.checkpoint_interop import save_params as jax_save_params
    from smoltts_tpu.models.dual_ar import init_params as jax_init

    d = tmp_path_factory.mktemp("bpe_ckpt")
    spec = _with(SPEC["tokenizer"], added_tokens=[])
    hf = hf_of(spec)
    base = hf.get_vocab_size()
    hf.add_special_tokens(special_token_list(CB))
    hf.save(str(d / "tokenizer.json"))
    cfg = jax_tiny(codebook_size=CB, vocab_size=base + 64 + CB)
    jax_save_params(jax.tree.map(np.asarray, jax_init(cfg, jax.random.PRNGKey(0))), cfg, d)
    return d


def test_smoltts_on_a_bpe_checkpoint_matches_jax(bpe_ckpt):
    from smoltts_tpu import SmolTTS as JaxSmolTTS
    from smoltts_tpu.codec import mimi as jm
    from smoltts_tpu.codec.config import MimiConfig as JaxMimiConfig
    from smoltts_tpu.lm.samplers import GenerationSettings as JaxSettings
    from smoltts_torch import SmolTTS
    from smoltts_torch.codec import mimi as tm
    from smoltts_torch.codec.config import MimiConfig
    from smoltts_torch.lm.samplers import GenerationSettings

    mimi = dict(num_filters=8, upsampling_ratios=[4, 3, 2], hidden_size=32,
                num_hidden_layers=2, num_attention_heads=2, head_dim=16, intermediate_size=64,
                codebook_size=CB, codebook_dim=16, num_quantizers=8, upsample_groups=32,
                frame_rate=500.0)
    gs = dict(default_temp=0.0, default_fast_temp=0.0, max_new_tokens=6,
              audio_only_constraint=True)
    jtts = JaxSmolTTS(bpe_ckpt, generation_settings=JaxSettings(**gs))
    jtts.codec_config = JaxMimiConfig(**mimi)
    jtts.codec_params = jm.init_mimi_params(jtts.codec_config, seed=0)
    tts = SmolTTS(bpe_ckpt, generation_settings=GenerationSettings(**gs), device="cpu")
    tts.codec_config = MimiConfig(**mimi)
    tts.codec_params = tm.init_mimi_params(tts.codec_config, seed=0, device="cpu")
    assert isinstance(tts.tokenizer, BPETokenizer)
    for f in ("im_end_id", "pad_id", "semantic_start_id", "semantic_end_id"):
        assert getattr(tts.token_config, f) == getattr(jtts.token_config, f), f
    for text in ("Hello world, it's 2024.", "Größe 12½ — systematic <|im_end|> text"):
        np.testing.assert_array_equal(tts._get_prompt(text, "bella"),
                                      jtts._get_prompt(text, "bella"))
    ref = jtts("Hello world, it's 2024.", voice="bella")
    got = tts("Hello world, it's 2024.", voice="bella")
    assert got.size > 0 and got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)
