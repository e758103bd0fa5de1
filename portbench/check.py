"""How `correct` is decided for a served model: the plain reference run
once over each sampled stream's prompt and served tokens.

Numbers compared (each must stay at or below its limit, from the cell's
workloads/<cell>.json):

- `token_gap`: the widest gap, in logits, by which a served token (the
  slow token and every codebook level of every frame) lies below the
  reference's best at its position. The traffic decodes greedily, so a
  sound program serves the reference's argmax up to rounding.
- `pcm_err`: the worst stream's RMS error of the served PCM against the
  reference vocoder's over the served codes (both clipped to [-1, 1], as
  int16 PCM is), relative to the reference's RMS.
- `bad_streams`: finished streams that end short of their frame budget
  without <|im_end|>, carry codes out of range, or PCM of the wrong length
  (limit 0), over every finished stream of the run.

The sample is drawn from the run's seed among the streams that finished,
with the longest always in it. The reference gets the weights anew from the
seed (portbench/weights.py) and derives its own int8 values from them.
"""

from __future__ import annotations

import dataclasses
import math
import sys
from typing import List, Optional

import numpy as np
import torch

from portbench.reference.dual_ar import DualAR
from portbench.reference.mimi import MimiDecoder, samples_per_frame
from portbench.reference.quant import Precision
from portbench.traffic import Request
from portbench.weights import dual_ar_specs, make_state, mimi_specs


@dataclasses.dataclass
class Number:
    name: str
    value: float
    limit: Optional[float]

    @property
    def ok(self) -> bool:
        return self.limit is not None and self.value <= self.limit


def stated_precision(config: dict) -> Precision:
    s = config["serving"]
    bits = {"int8": 8, "bf16": None}
    return Precision(matrix_bits=bits[s["lm_weights"]], kv_bits=bits[s["kv_cache"]],
                     table=s["dense_weights"])


def sample(finished: List[Request], n: int, seed: int) -> List[Request]:
    """n of the finished streams drawn from the seed, the longest first."""
    if not finished:
        return []
    longest = max(finished, key=lambda r: (len(r.frames), -r.idx))
    rest = [r for r in finished if r is not longest]
    rng = np.random.default_rng([int(seed), 0xC4EC])
    pick = rng.choice(len(rest), size=min(n - 1, len(rest)), replace=False) if rest else []
    return [longest] + [rest[i] for i in sorted(pick)]


def stream_arrays(r: Request):
    """(prompt [R, T0], served frames [n, R] (slow token, codes), PCM as
    float32 in [-1, 1] [n * spf]; int16 PCM is read as the program scales
    it, by 32767)."""
    frames = np.stack([np.concatenate([[f["slow_token"]], f["audio_codes"]]) for f in r.frames])
    pcm = np.concatenate([np.asarray(f["pcm"]).reshape(-1) for f in r.frames])
    pcm = pcm.astype(np.float32) / 32767.0 if pcm.dtype == np.int16 else pcm.astype(np.float32)
    return r.prompt, frames.astype(np.int64), pcm


def bad_streams(finished: List[Request], config: dict) -> int:
    vocab, model = config["vocab"], config["model"]
    spf = samples_per_frame(config["codec"])
    bad = 0
    for r in finished:
        n = len(r.frames)
        ok = n > 0 and (n == r.budget or (n < r.budget
                                          and r.frames[-1]["slow_token"] == vocab["im_end"]))
        for f in r.frames:
            codes = np.asarray(f["audio_codes"])
            ok = ok and codes.shape == (model["num_codebooks"],) and 0 <= codes.min() \
                and codes.max() < model["codebook_size"] and np.asarray(f["pcm"]).size == spf
        bad += not ok
    return bad


@torch.no_grad()
def readings(lm: DualAR, voc: MimiDecoder, streams: List[Request], control=None) -> dict:
    """token_gap and pcm_err of the served streams against the reference
    (`lm`, `voc`); with `control` = (lm', voc'), the same numbers of the
    control: the token it puts first at each served position, and its PCM
    from the served codes."""
    gap = err = 0.0
    for r in streams:
        prompt, frames, pcm = stream_arrays(r)
        slow, codes = lm.served_logits(torch.from_numpy(prompt), torch.from_numpy(frames))
        served = torch.from_numpy(frames).to(slow.device)
        if control is None:
            picked_slow, picked_codes = served[:, 0], served[:, 1:]
        else:
            cs, cc = control[0].served_logits(torch.from_numpy(prompt), torch.from_numpy(frames))
            picked_slow, picked_codes = cs.argmax(-1), cc.argmax(-1)
        g_slow = slow.max(-1).values - slow.gather(-1, picked_slow[:, None])[:, 0]
        g_codes = codes.max(-1).values - codes.gather(-1, picked_codes[..., None])[..., 0]
        gap = max(gap, float(g_slow.max()), float(g_codes.max()))
        ref = voc.decode(served[:, 1:].T).clamp(-1.0, 1.0)
        if control is None:
            got = torch.from_numpy(pcm).to(ref.device).clamp(-1.0, 1.0)
        else:
            got = control[1].decode(served[:, 1:].T).clamp(-1.0, 1.0)
        e = torch.sqrt(((got - ref) ** 2).mean() / (ref ** 2).mean().clamp_min(1e-30))
        err = max(err, float(e))
    return {"token_gap": gap, "pcm_err": err}


def reference_models(config: dict, seed: int, device, prec: Precision):
    """The reference's LM and vocoder from the seed's weights at `prec`."""
    state = make_state(dual_ar_specs(config["model"]), seed, device)
    lm = DualAR(state, config["model"], config["vocab"], prec, device)
    del state
    mstate = make_state(mimi_specs(config["codec"]), seed, device, stream=1)
    voc = MimiDecoder(mstate, config["codec"], prec, device)
    return lm, voc


def served(config: dict, workload: dict, seed: int, finished: List[Request],
           device) -> List[Number]:
    """The numbers that decide `correct` for a run's finished streams."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    check = workload.get("check", {})
    limits = check.get("limits", {})
    streams = sample(finished, check.get("requests", 8), seed)
    out = [Number("bad_streams", float(bad_streams(finished, config)), 0.0)]
    if not streams:
        return out + [Number("token_gap", math.inf, limits.get("token_gap")),
                      Number("pcm_err", math.inf, limits.get("pcm_err"))]
    lm, voc = reference_models(config, seed, device, stated_precision(config))
    got = readings(lm, voc, streams)
    return out + [Number(k, v, limits.get(k)) for k, v in got.items()]


def report(numbers: List[Number]) -> dict:
    """Print each number beside its limit on standard error; the same as a
    dict for the result line."""
    out = {}
    for n in numbers:
        lim = "none" if n.limit is None else repr(n.limit)
        print(f"check {n.name} {n.value!r} limit {lim}", file=sys.stderr)
        out[n.name] = {"value": n.value, "limit": n.limit}
    return out
