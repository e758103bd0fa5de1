"""The general traffic generator: requests and arrivals from a traffic
file's parameters and the run's seed.

A request is one ChatML turn for text-to-speech: a system turn naming a
speaker, a user turn holding the text, and the open assistant header, as
token rows [R, T] of the configuration's byte-level vocabulary (ids from
the configuration file's `vocab`). Its text length is lognormal, and its
frame budget follows from the length at a speaking rate.

Every seed gets the same multiset of sizes: the lengths are drawn once from
the traffic file's own `pool.seed`, and the run's seed only orders them and
draws the text, the speakers and the arrival times.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

# Letters without "s": no text can spell the control words "system",
# "user" or "assistant", which the byte-level tokenizer maps to one id.
ALPHABET = "abcdefghijklmnopqrtuvwxyz"
CHATML_TOKENS = 12  # the ids of a request's prompt around its text


@dataclasses.dataclass
class Request:
    idx: int
    text: str
    speaker: int
    budget: int  # frames
    prompt: np.ndarray  # [R, T] int32
    due: Optional[float] = None  # open loop: when it was due to be sent
    submit: Optional[float] = None  # when it was handed to the system
    first: Optional[float] = None  # first PCM frame at the client
    ended: Optional[float] = None  # end of stream at the client
    arrivals: List[float] = dataclasses.field(default_factory=list)
    frames: List[dict] = dataclasses.field(default_factory=list)
    queue_wait: Optional[float] = None  # the program's submit -> prefill stamp, s

    @property
    def start(self) -> float:
        """Where the request's latency starts: when it was due, else sent."""
        return self.due if self.due is not None else self.submit


def pool_sizes(traffic: dict) -> List[tuple]:
    """The traffic's fixed multiset of (text bytes, frame budget)."""
    spec, frames = traffic["text_bytes"], traffic["frames"]
    rng = np.random.default_rng(traffic["pool"]["seed"])
    n = traffic["pool"]["size"]
    lengths = np.exp(rng.normal(np.log(spec["median"]), spec["sigma"], n))
    lengths = np.clip(np.round(lengths), spec["min"], spec["max"]).astype(int)
    budgets = np.clip(np.round(lengths / frames["bytes_per_s"] / frames["frame_s"]),
                      frames["min"], frames["max"]).astype(int)
    return list(zip(lengths.tolist(), budgets.tolist()))


def random_text(rng: np.random.Generator, n: int) -> str:
    """n bytes of lowercase words separated by single spaces."""
    chars = []
    while len(chars) < n:
        word = rng.integers(2, 9)
        chars.extend(ALPHABET[i] for i in rng.integers(0, len(ALPHABET), word))
        chars.append(" ")
    text = "".join(chars[:n])
    return text[:-1] + "." if text.endswith(" ") else text


def chatml_prompt(text: str, speaker: int, vocab: dict, rows: int) -> np.ndarray:
    """The byte-level ChatML prompt of one request: [rows, T] int32 with
    the ids in row 0 and zeros in the codebook rows."""
    v = vocab
    ids = ([v["im_start"], v["system"], v["newline"], v["speaker_0"] + speaker, v["im_end"],
            v["im_start"], v["user"], v["newline"]]
           + list(text.encode("latin-1"))
           + [v["im_end"], v["im_start"], v["assistant"], v["newline"]])
    out = np.zeros((rows, len(ids)), np.int32)
    out[0] = ids
    return out


def stratified_order(sizes: List[tuple], rng: np.random.Generator, rounds: int) -> np.ndarray:
    """An order of the pool in which every run of `len(sizes) // rounds`
    consecutive requests holds one request of each size stratum (the pool
    sorted by budget and cut into that many strata), so that any stretch of
    traffic carries nearly the pool's whole mix of sizes."""
    n = len(sizes)
    per = n // rounds  # strata
    by_size = np.argsort([b for _, b in sizes], kind="stable")[: per * rounds]
    strata = by_size.reshape(per, rounds)  # row i: the i-th size stratum
    strata = np.stack([rng.permutation(row) for row in strata])
    return np.concatenate([rng.permutation(strata[:, r]) for r in range(rounds)])


def requests(traffic: dict, vocab: dict, rows: int, seed: int) -> List[Request]:
    """The run's requests in the order they are sent."""
    rng = np.random.default_rng([int(seed), 0x7EA])
    sizes = pool_sizes(traffic)
    order = stratified_order(sizes, rng, traffic["pool"]["rounds"])
    out = []
    for i, j in enumerate(order):
        n_bytes, budget = sizes[j]
        text = random_text(rng, n_bytes)
        speaker = int(rng.integers(0, traffic["speakers"]))
        out.append(Request(idx=i, text=text, speaker=speaker, budget=budget,
                           prompt=chatml_prompt(text, speaker, vocab, rows)))
    return out


def residual_budgets(reqs: List[Request], seed: int) -> None:
    """Shorten each request to a share of its budget spread evenly over
    (0, 1) (at least one frame): the first requests of a closed loop then
    stand at points of their streams spread as in steady state, and the
    loop starts steady."""
    shares = (np.random.default_rng([int(seed), 0x5EED]).permutation(len(reqs)) + 0.5) / len(reqs)
    for r, u in zip(reqs, shares):
        r.budget = max(1, int(np.ceil(u * r.budget)))


def poisson_arrivals(traffic: dict, n: int, seed: int) -> np.ndarray:
    """n arrival offsets (s) of a Poisson process at the traffic's `rate`
    per second: the gaps drawn once from the pool's seed, ordered by the
    run's seed."""
    gaps = np.random.default_rng([traffic["pool"]["seed"], 0xA77]).exponential(
        1.0 / traffic["rate"], n)
    order = np.random.default_rng([int(seed), 0xA77]).permutation(n)
    return np.cumsum(gaps[order])


def warm_requests(traffic: dict, vocab: dict, rows: int, bucket: int = 64) -> List[Request]:
    """One short request at every prompt bucket the traffic can produce
    (prompts pad to multiples of `bucket`), and one long enough to reach a
    cache flush: what a driver streams in set-up so that no shape is new
    inside the window."""
    spec, longest = traffic["text_bytes"], traffic["text_bytes"]["max"] + CHATML_TOKENS
    out = []
    for b in range(bucket, -(-longest // bucket) * bucket + 1, bucket):
        n = max(spec["min"], min(spec["max"], b - CHATML_TOKENS))
        text = random_text(np.random.default_rng(b), n)
        out.append(Request(idx=-b, text=text, speaker=0, budget=2,
                           prompt=chatml_prompt(text, 0, vocab, rows)))
    out[0].budget = traffic["frames"]["flush_reach"]
    return out
