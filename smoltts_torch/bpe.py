"""A BPE tokenizer read from an HF `tokenizers` `tokenizer.json`, in plain
Python (the card's machine has neither `tokenizers` nor `regex`).

It reads the parts of the format that a Llama-style byte-level BPE file
uses, and gives the ids HF `tokenizers` gives:
  model          BPE: `vocab`, `merges` ("a b" strings or ["a", "b"] pairs),
                 `unk_token`, `continuing_subword_prefix`,
                 `end_of_word_suffix`, `fuse_unk`, `byte_fallback`,
                 `ignore_merges`; `dropout` null
  normalizer     null, NFC, NFKC, or a Sequence of them
  pre_tokenizer  null, ByteLevel (`add_prefix_space`, `use_regex`), Digits
                 (`individual_digits`), or a Sequence of them
  added_tokens   `special`, `lstrip`, `rstrip`, `single_word`, `normalized`
  decoder        null or ByteLevel
  post_processor null or ByteLevel (neither adds ids)
Anything else raises NotImplementedError naming it.

The pipeline is HF's: added tokens are cut out first (leftmost-longest,
non-overlapping; the un-normalized ones from the raw text, the normalized
ones from each normalized remainder), the remainders are normalized and
pre-tokenized, and each pre-token goes through the BPE merges by rank.
Character classes follow the Unicode tables of this Python
(`unicodedata`): a character assigned in a later Unicode version than
Python's may be classed differently from HF's Rust tables.
"""

from __future__ import annotations

import heapq
import itertools
import json
import unicodedata
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Tuple, Union

# Rust's `char::is_whitespace` and Oniguruma's Unicode `\s`: the White_Space
# property (not `str.isspace`, which also takes U+001C-U+001F).
WHITE_SPACE = frozenset(chr(c) for c in [
    *range(0x09, 0x0E), 0x20, 0x85, 0xA0, 0x1680, *range(0x2000, 0x200B), 0x2028, 0x2029,
    0x202F, 0x205F, 0x3000])
# Symbols (So) with the Other_Alphabetic property: circled and squared
# letters, which `\w` takes as word characters.
_OTHER_ALPHABETIC_SO = ((0x24B6, 0x24E9), (0x1F130, 0x1F149), (0x1F150, 0x1F169),
                        (0x1F170, 0x1F189))


def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's byte -> printable character table."""
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = list(bs)
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return {b: chr(c) for b, c in zip(bs, cs)}


BYTE_CHAR = bytes_to_unicode()
CHAR_BYTE = {c: b for b, c in BYTE_CHAR.items()}


def _is_letter(c: str) -> bool:
    return unicodedata.category(c)[0] == "L"


def _is_number(c: str) -> bool:
    return unicodedata.category(c)[0] == "N"


def _is_word_char(c: str) -> bool:
    """`\\w`: Alphabetic, marks, decimal digits, connector punctuation and
    the join controls."""
    cat = unicodedata.category(c)
    if cat[0] in "LM" or cat in ("Nd", "Nl", "Pc") or c in "\u200c\u200d":
        return True
    return cat == "So" and any(lo <= ord(c) <= hi for lo, hi in _OTHER_ALPHABETIC_SO)


_CONTRACTIONS = ("s", "t", "re", "ve", "m", "ll", "d")


def gpt2_split(text: str) -> List[str]:
    """The pieces of `text` under GPT-2's pattern
    `'s|'t|'re|'ve|'m|'ll|'d| ?\\p{L}+| ?\\p{N}+| ?[^\\s\\p{L}\\p{N}]+|\\s+(?!\\S)|\\s+`,
    scanned by hand with the regex's alternation order and backtracking."""
    out = []
    i, n = 0, len(text)

    def run(j, pred):
        while j < n and pred(text[j]):
            j += 1
        return j

    def other(c):
        return c not in WHITE_SPACE and not _is_letter(c) and not _is_number(c)

    while i < n:
        c = text[i]
        end = None
        if c == "'":
            for s in _CONTRACTIONS:
                if text.startswith(s, i + 1):
                    end = i + 1 + len(s)
                    break
        if end is None:  # ` ?\p{L}+`, ` ?\p{N}+`, ` ?[^\s\p{L}\p{N}]+`
            start = i + 1 if c == " " and i + 1 < n else i
            for pred in (_is_letter, _is_number, other):
                if pred(text[start]):
                    end = run(start + 1, pred)
                    break
        if end is None:  # whitespace: `\s+(?!\S)`, else `\s+`
            j = run(i + 1, lambda ch: ch in WHITE_SPACE)
            end = j if j == n or j - i == 1 else j - 1
        out.append(text[i:end])
        i = end
    return out


def _split_digits(text: str, individual: bool) -> List[str]:
    """Digits: runs of numeric characters (Nd, Nl, No) apart from the rest,
    and each one alone if `individual`."""
    out = []
    for numeric, group in itertools.groupby(text, _is_number):
        g = "".join(group)
        out.extend(g if numeric and individual else [g])
    return out


def _unsupported(where: str, spec) -> NotImplementedError:
    kind = spec.get("type") if isinstance(spec, dict) else spec
    return NotImplementedError(f"tokenizer.json {where} {kind!r} is not supported by the "
                               f"port's BPE tokenizer")


def _normalizer(spec) -> List[str]:
    """The Unicode normal forms to apply, in order."""
    if spec is None:
        return []
    kind = spec.get("type")
    if kind == "Sequence":
        return [f for sub in spec["normalizers"] for f in _normalizer(sub)]
    if kind in ("NFC", "NFKC"):
        return [kind]
    raise _unsupported("normalizer", spec)


def _pre_tokenizer(spec) -> List[Tuple[str, bool, bool]]:
    """[(kind, flag, flag)]: ("ByteLevel", add_prefix_space, use_regex) or
    ("Digits", individual_digits, _)."""
    if spec is None:
        return []
    kind = spec.get("type")
    if kind == "Sequence":
        return [p for sub in spec["pretokenizers"] for p in _pre_tokenizer(sub)]
    if kind == "ByteLevel":
        return [("ByteLevel", bool(spec.get("add_prefix_space", True)),
                 bool(spec.get("use_regex", True)))]
    if kind == "Digits":
        return [("Digits", bool(spec.get("individual_digits", False)), False)]
    raise _unsupported("pre_tokenizer", spec)


class AddedToken:
    __slots__ = ("id", "content", "special", "lstrip", "rstrip", "single_word", "normalized")

    def __init__(self, d: dict):
        self.id = -1  # given by BPETokenizer, as HF gives it
        self.content = d["content"]
        self.special = bool(d.get("special", False))
        self.lstrip = bool(d.get("lstrip", False))
        self.rstrip = bool(d.get("rstrip", False))
        self.single_word = bool(d.get("single_word", False))
        self.normalized = bool(d.get("normalized", not self.special))


class _Matcher:
    """Leftmost-longest, non-overlapping matching of added tokens (as HF's
    Aho-Corasick automaton with MatchKind::LeftmostLongest)."""

    def __init__(self, tokens: Dict[str, AddedToken]):
        self.tokens = tokens
        self.first: Dict[str, List[str]] = {}
        for content in sorted(tokens, key=len, reverse=True):
            if content:
                self.first.setdefault(content[0], []).append(content)

    def find(self, text: str) -> Iterable[Tuple[int, int, AddedToken]]:
        i, n = 0, len(text)
        while i < n:
            for content in self.first.get(text[i], ()):
                if text.startswith(content, i):
                    yield i, i + len(content), self.tokens[content]
                    i += len(content)
                    break
            else:
                i += 1


def _split_added(text: str, matcher: _Matcher) -> List[Tuple[str, Optional[int]]]:
    """[(piece, added-token id or None)] as HF's `find_matches`: a
    single_word token needs non-word characters (or the text's ends) on both
    sides; lstrip / rstrip take the whitespace beside the token into it."""
    if not matcher.tokens:
        return [(text, None)]
    out, start_offset = [], 0
    for start, stop, tok in matcher.find(text):
        if tok.single_word:
            before_ok = start == 0 or not _is_word_char(text[start - 1])
            after_ok = stop == len(text) or not _is_word_char(text[stop])
            if not (before_ok and after_ok):
                continue
        if tok.lstrip:
            s = start
            while s > 0 and text[s - 1] in WHITE_SPACE:
                s -= 1
            start = max(s, start_offset)
        if tok.rstrip:
            while stop < len(text) and text[stop] in WHITE_SPACE:
                stop += 1
        if start_offset < start:
            out.append((text[start_offset:start], None))
        out.append((text[start:stop], tok.id))
        start_offset = stop
    if start_offset < len(text):
        out.append((text[start_offset:], None))
    return out


class BPETokenizer:
    """`encode(text) -> ids`, `decode(ids) -> text`, `token_to_id`,
    `id_to_token`, `vocab_size`: the interface of `ByteTokenizer`."""

    def __init__(self, spec: dict):
        for key in ("truncation", "padding"):
            if spec.get(key) is not None:
                raise _unsupported(key, key)
        model = spec.get("model") or {}
        if model.get("type", "BPE") != "BPE":
            raise _unsupported("model", model)
        if model.get("dropout") not in (None, 0, 0.0):
            raise NotImplementedError(f"tokenizer.json BPE dropout {model['dropout']} is not "
                                      f"supported by the port's BPE tokenizer")
        if spec.get("decoder") is not None and spec["decoder"].get("type") != "ByteLevel":
            raise _unsupported("decoder", spec["decoder"])
        if spec.get("post_processor") is not None and \
                spec["post_processor"].get("type") != "ByteLevel":
            raise _unsupported("post_processor", spec["post_processor"])
        self.normal_forms = _normalizer(spec.get("normalizer"))
        self.pre_tokenizers = _pre_tokenizer(spec.get("pre_tokenizer"))
        self.byte_level_decoder = spec.get("decoder") is not None

        self.vocab: Dict[str, int] = dict(model.get("vocab") or {})
        self.unk_token: Optional[str] = model.get("unk_token")
        self.prefix: Optional[str] = model.get("continuing_subword_prefix")
        self.suffix: Optional[str] = model.get("end_of_word_suffix")
        self.fuse_unk = bool(model.get("fuse_unk", False))
        self.byte_fallback = bool(model.get("byte_fallback", False))
        self.ignore_merges = bool(model.get("ignore_merges", False))
        prefix_len = len(self.prefix or "")
        self.merges: Dict[Tuple[int, int], Tuple[int, int]] = {}
        for rank, m in enumerate(model.get("merges") or []):
            if isinstance(m, str):
                parts = m.split(" ")
                if len(parts) != 2:
                    raise ValueError(f"tokenizer.json: merge {rank + 1} ({m!r}) is not 'a b'")
                a, b = parts
            else:
                a, b = m
            for t in (a, b, a + b[prefix_len:]):
                if t not in self.vocab:
                    raise ValueError(f"tokenizer.json: merge token {t!r} is not in the vocab")
            self.merges[(self.vocab[a], self.vocab[b])] = (rank, self.vocab[a + b[prefix_len:]])
        self.id_to_vocab = {i: t for t, i in self.vocab.items()}

        added = [AddedToken(d) for d in spec.get("added_tokens") or []]
        # HF adds the added tokens again in file order, each with the id it
        # gets now (the file's ids are not read): the vocab's id for a token
        # in the vocab; else one past the largest id given so far to a token
        # outside the vocab, or the vocab's entry count while that is larger.
        ids: Dict[str, int] = {}
        top = -1
        for t in added:
            if t.content in self.vocab:
                t.id = self.vocab[t.content]
            elif t.content in ids:
                t.id = ids[t.content]
            else:
                t.id = top = max(top + 1, len(self.vocab))
            ids[t.content] = t.id
        self.added = {t.content: t for t in added}
        self.added_by_id = {t.id: t for t in added}
        self._raw_matcher = _Matcher({t.content: t for t in added if not t.normalized})
        self._norm_matcher = _Matcher({self._normalize(t.content): t for t in added
                                       if t.normalized})
        self.vocab_size = len(set(self.vocab) | set(self.added))

    @classmethod
    def from_file(cls, path: Union[str, Path]) -> "BPETokenizer":
        with open(path, "r", encoding="utf-8") as f:
            return cls(json.load(f))

    # ---- the vocabulary ------------------------------------------------

    def token_to_id(self, token: str) -> Optional[int]:
        if token in self.added:
            return self.added[token].id
        return self.vocab.get(token)

    def id_to_token(self, idx: int) -> Optional[str]:
        if idx in self.added_by_id:
            return self.added_by_id[idx].content
        return self.id_to_vocab.get(idx)

    # ---- encode ----------------------------------------------------------

    def _normalize(self, text: str) -> str:
        for form in self.normal_forms:
            text = unicodedata.normalize(form, text)
        return text

    def _pre_tokenize(self, text: str) -> List[str]:
        pieces = [text]
        for kind, flag, use_regex in self.pre_tokenizers:
            nxt = []
            for p in pieces:
                if kind == "Digits":
                    nxt.extend(_split_digits(p, flag))
                    continue
                if flag and not p.startswith(" "):
                    p = " " + p
                nxt.extend("".join(BYTE_CHAR[b] for b in q.encode("utf-8"))
                           for q in (gpt2_split(p) if use_regex else [p]))
            pieces = [p for p in nxt if p]
        return pieces

    def _symbols(self, word: str) -> List[int]:
        ids: List[int] = []
        unk: Optional[int] = None  # the pending unk's id
        for i, c in enumerate(word):
            s = c
            if i > 0 and self.prefix is not None:
                s = self.prefix + s
            if i == len(word) - 1 and self.suffix is not None:
                s = s + self.suffix
            if s in self.vocab:
                if unk is not None:
                    ids.append(unk)
                    unk = None
                ids.append(self.vocab[s])
                continue
            if self.byte_fallback:
                fb = [self.vocab.get(f"<0x{b:02X}>") for b in s.encode("utf-8")]
                if all(t is not None for t in fb):
                    ids.extend(fb)
                    continue
            if self.unk_token is not None:
                if self.unk_token not in self.vocab:
                    raise ValueError(f"tokenizer.json: unk_token {self.unk_token!r} is not "
                                     f"in the vocab")
                if unk is not None and not self.fuse_unk:
                    ids.append(unk)
                unk = self.vocab[self.unk_token]
            # no byte fallback and no unk token: the character is dropped
        if unk is not None:
            ids.append(unk)
        return ids

    def _merge(self, ids: List[int]) -> List[int]:
        """HF's `Word::merge_all`: the pair of lowest rank first, the
        leftmost among equals; stale queue entries are skipped."""
        n = len(ids)
        sym = list(ids)
        alive = [True] * n
        prev = list(range(-1, n - 1))
        nxt = list(range(1, n)) + [-1]
        queue = []
        for i in range(n - 1):
            m = self.merges.get((sym[i], sym[i + 1]))
            if m is not None:
                queue.append((m[0], i, m[1]))
        heapq.heapify(queue)
        while queue:
            _, pos, new_id = heapq.heappop(queue)
            if not alive[pos] or nxt[pos] == -1:
                continue
            right = nxt[pos]
            m = self.merges.get((sym[pos], sym[right]))
            if m is None or m[1] != new_id:
                continue
            sym[pos] = new_id
            alive[right] = False
            nxt[pos] = nxt[right]
            if nxt[pos] != -1:
                prev[nxt[pos]] = pos
            if prev[pos] >= 0:
                m = self.merges.get((sym[prev[pos]], new_id))
                if m is not None:
                    heapq.heappush(queue, (m[0], prev[pos], m[1]))
            if nxt[pos] != -1:
                m = self.merges.get((new_id, sym[nxt[pos]]))
                if m is not None:
                    heapq.heappush(queue, (m[0], pos, m[1]))
        return [s for s, a in zip(sym, alive) if a]

    def _tokenize_word(self, word: str) -> List[int]:
        if self.ignore_merges and word in self.vocab:
            return [self.vocab[word]]
        return self._merge(self._symbols(word))

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        for piece, tid in _split_added(text, self._raw_matcher):
            if tid is not None:
                ids.append(tid)
                continue
            for sub, sid in _split_added(self._normalize(piece), self._norm_matcher):
                if sid is not None:
                    ids.append(sid)
                    continue
                for word in self._pre_tokenize(sub):
                    ids.extend(self._tokenize_word(word))
        return ids

    # ---- decode ----------------------------------------------------------

    def decode(self, ids: List[int], skip_special_tokens: bool = False) -> str:
        """Text of `ids`. The ByteLevel decoder maps each token whose
        characters are all byte symbols back to those bytes, keeps any other
        token's UTF-8, and decodes the whole with replacement characters (as
        HF); without a decoder the tokens are joined by spaces."""
        tokens = []
        for i in ids:
            tok = self.id_to_token(int(i))
            if tok is None:
                continue
            if skip_special_tokens and i in self.added_by_id and self.added_by_id[i].special:
                continue
            tokens.append(tok)
        if not self.byte_level_decoder:
            return " ".join(tokens)
        out = bytearray()
        for t in tokens:
            if all(c in CHAR_BYTE for c in t):
                out.extend(CHAR_BYTE[c] for c in t)
            else:
                out.extend(t.encode("utf-8"))
        return out.decode("utf-8", errors="replace")
