#!/usr/bin/env python3
"""Write tests/data/torch_bpe_fixture.json: a small byte-level BPE
`tokenizer.json` trained with HF `tokenizers`, with SmolLM2's pre-tokenizer
(Sequence[Digits(individual_digits), ByteLevel(add_prefix_space=False)]),
the smoltts special tokens as added tokens, and about 200 strings with the
ids HF `tokenizers` gives them.

    python3 scripts/torch_bpe_fixture.py [--out tests/data/torch_bpe_fixture.json]

Needs `tokenizers` (not on the card's machine; the port's `smoltts_torch.bpe`
reads the file without it). The corpus is SURVEY.md and PAPER.md plus the
multilingual lines below; the strings are the same lines, edge cases of the
pre-tokenizer and seeded random Unicode.
"""

from __future__ import annotations

import argparse
import json
import sys
import unicodedata
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

VOCAB_SIZE = 1800  # 256 byte symbols and about 1,500 merges
LINES = [
    "The quick brown fox jumps over the lazy dog.",
    "She said, \"I'll be there at 10:30 — don't wait!\"",
    "They're sure we've seen it; it's the 3rd time I'm told.",
    "Größe, Straße, naïve café, façade, jalapeño, Ångström.",
    "Съешь же ещё этих мягких французских булок, да выпей чаю.",
    "Ελληνικά γράμματα και αριθμοί 12345.",
    "日本語のテキストと、中文的文本，한국어 텍스트.",
    "العربية تكتب من اليمين إلى اليسار ١٢٣٤.",
    "हिन्दी में लिखा गया वाक्य है। ४५६",
    "Emoji: 😀🎉👍🏽 and flags 🇫🇷🇯🇵, math ∑∫√∞ ≤ ≥.",
    "Prices: $1,299.99, €45, £7.50, ¥1000, 50% off!!!",
    "Tabs\tand\nnewlines\r\nand   multiple    spaces.",
    "Numbers like 3.14159, 2,718 and 1e-9 or 0x1F.",
]
EDGE = [
    "", " ", "  ", "\t", "\n\n", " \n ", "a", "'s", "'S", "don't", "''s", "' s",
    "x  y", "x \t y", "x\xa0y", "x\u3000y", "x\x1cy", "x\x1fy", "x\x85y", "end   ",
    "123456789", "1 2 3", "①②③ ½ ² Ⅻ", "٣٤٥", "a1b2c3",
    "<|im_start|>user\nHello<|im_end|>\n<|im_start|>assistant\n",
    "<|speaker:3|><|semantic:0|><|semantic:2047|>", "systematic users of assistants",
    "<|im_end|><|im_end|>", "<|not_special|>", "<|semantic:2048|>", "<<|pad|>>",
    "\u24b6\u24d1\U0001f150 circled", "e\u0301 vs \xe9", "\ufb01 ligature",
    "zero\u200bwidth\u200djoin", "\u0661\u00b2 mixed \u2167",
]


def corpus():
    for name in ("SURVEY.md", "PAPER.md"):
        p = ROOT / name
        if p.exists():
            yield from p.read_text(encoding="utf-8").splitlines()
    yield from LINES * 20


def random_strings(n: int, seed: int = 0):
    """Seeded strings over ASCII, Latin-1, general Unicode (assigned in this
    Python's tables) and the special tokens."""
    from smoltts_torch.tokenizer import special_token_list

    rng = np.random.default_rng(seed)
    specials = special_token_list(2048)
    pools = [
        [chr(c) for c in range(0x20, 0x7F)] + ["\n", "\t", "'", "\xa0", "\u3000"],
        [chr(c) for c in range(0xA0, 0x250)],
        [chr(c) for c in range(0x30, 0x3A)] + ["٣", "٤", "½", "²", "Ⅻ"],
    ]
    out = []
    while len(out) < n:
        parts = []
        for _ in range(int(rng.integers(1, 12))):
            k = int(rng.integers(0, 5))
            if k < 3:
                pool = pools[k]
                parts.append("".join(pool[int(i)] for i in rng.integers(0, len(pool),
                                                                       int(rng.integers(1, 8)))))
            elif k == 3:
                parts.append(specials[int(rng.integers(0, 80))])
            else:
                cs = []
                while len(cs) < int(rng.integers(1, 6)):
                    c = chr(int(rng.integers(0x20, 0x30000)))
                    if unicodedata.category(c) not in ("Cn", "Cs"):
                        cs.append(c)
                parts.append("".join(cs))
        out.append("".join(parts))
    return out


def build():
    from tokenizers import Tokenizer, decoders, models, pre_tokenizers, trainers

    from smoltts_torch.tokenizer import special_token_list

    tok = Tokenizer(models.BPE())
    tok.pre_tokenizer = pre_tokenizers.Sequence([
        pre_tokenizers.Digits(individual_digits=True),
        pre_tokenizers.ByteLevel(add_prefix_space=False),
    ])
    tok.decoder = decoders.ByteLevel()
    trainer = trainers.BpeTrainer(vocab_size=VOCAB_SIZE, min_frequency=2, show_progress=False,
                                  initial_alphabet=pre_tokenizers.ByteLevel.alphabet())
    tok.train_from_iterator(corpus(), trainer)
    tok.add_special_tokens(special_token_list(2048))
    return tok


def main(argv=None) -> int:
    import tokenizers

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=str(ROOT / "tests" / "data" / "torch_bpe_fixture.json"))
    args = ap.parse_args(argv)
    tok = build()
    texts = LINES + EDGE + [ln for ln in (ROOT / "PAPER.md").read_text(encoding="utf-8")
                            .splitlines() if ln.strip()][:40]
    texts += random_strings(200 - len(texts))
    cases = [{"text": t, "ids": tok.encode(t).ids} for t in texts]
    spec = json.loads(tok.to_str())
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"tokenizers_version": tokenizers.__version__, "tokenizer": spec,
                               "cases": cases}, ensure_ascii=False, separators=(",", ":")),
                   encoding="utf-8")
    n_merges = len(spec["model"]["merges"])
    print(f"wrote {out}: {len(spec['model']['vocab'])} vocab, {n_merges} merges, "
          f"{len(spec['added_tokens'])} added tokens, {len(cases)} strings, "
          f"{out.stat().st_size} bytes")
    return 0


if __name__ == "__main__":
    sys.exit(main())
