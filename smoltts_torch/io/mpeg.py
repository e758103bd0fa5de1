"""Pure-numpy MPEG Audio Layer I/II encoder (mono) — the `audio/mpeg`
transcoding path behind `mp3_*` response formats. The port's copy of
`smoltts_tpu/io/mpeg.py`, with its own copies of the prototype windows
(`pqmf_window_iso.npz`, `pqmf_window.npz`) beside it.

The reference serves MP3 through pydub -> lame
(mlx_inference/src/smoltts_mlx/server/tts_core.py:69-82); neither pydub, nor
lame, nor ffmpeg exists in this environment, so this module implements an
MPEG audio encoder from scratch:

- Bitstream framing, header fields, bit allocation, scalefactors, and the
  quantizers follow ISO/IEC 11172-3 / 13818-3 semantics (the
  quantize/dequantize pairs use the standard C/D affine requantization
  family with MSB inversion), so any MPEG audio decoder parses these frames.
- The 512-tap polyphase prototype window is DESIGNED here (Kaiser-windowed
  sinc polished for joint reconstruction + stopband quality by
  scripts/design_pqmf.py) rather than copied from the spec's table C.1 —
  the tabulated window isn't available offline. The cosine modulation
  matches the standard's analysis/synthesis phase pair, so third-party
  decoders reconstruct with fidelity bounded by the (small)
  designed-vs-tabulated window difference; the matched round trip is
  asserted > 30 dB SNR in tests/test_mpeg.py (measured: >60 dB Layer II at
  48 kbps/24 kHz, >70 dB at 96+ kbps).

Two layers are implemented:

- **Layer II** at every supported rate — the default for all `mp3_*`
  response formats, including the ElevenLabs-default `mp3_44100_128`:
  - ISO/IEC 13818-3 LSF variant for 16/22.05/24 kHz (which includes this
    framework's native 24 kHz serving rate): one allocation table for every
    bitrate.
  - ISO/IEC 11172-3 MPEG-1 variant for 32/44.1/48 kHz: per-(rate, bitrate)
    allocation table selection over tables B.2a-d, reconstructed from the
    standard's class structure (the step ladders 3/5/7/9/15/... with the
    C = 2M/steps, D = 1/2-or-1/M requantization family and the nbal field
    widths per subband group) and cross-checked by the round-trip oracle.
  The quantizer classes (grouped 3/5/9-step, ungrouped 7..65535-step),
  scfsi scalefactor sharing, and bitstream framing are shared between the
  two variants.
- **Layer I** for the MPEG-1 rates (shorter 384-sample frames, single
  scalefactor, 4-bit allocation everywhere) — kept as an explicit
  `layer=1` fallback.

Layer III remains out of scope (documented API deviation: the payload is
standard MPEG audio with content type audio/mpeg, but Layer II frames,
which mainstream decoders — mpg123, ffmpeg, browsers — all play).
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import List, Optional, Tuple

import numpy as np

_SUBBANDS = 32
_GRANULES = 12  # subband samples per frame (Layer I)
_FRAME_SAMPLES = _SUBBANDS * _GRANULES  # 384

# (version_bits, samplerate_index) per sampling rate; version '11' = MPEG-1,
# '10' = MPEG-2 LSF.
_RATES = {
    44100: (0b11, 0),
    48000: (0b11, 1),
    32000: (0b11, 2),
    22050: (0b10, 0),
    24000: (0b10, 1),
    16000: (0b10, 2),
}
# Layer I bitrate tables (kbps), index 1..14.
_BITRATES_V1 = [0, 32, 64, 96, 128, 160, 192, 224, 256, 288, 320, 352, 384, 416, 448]
_BITRATES_V2 = [0, 32, 48, 56, 64, 80, 96, 112, 128, 144, 160, 176, 192, 224, 256]

# Layer I/II scalefactor table: sf(i) = 2 * 2^(-i/3), i = 0..62.
_SCALEFACTORS = 2.0 * np.power(2.0, -np.arange(63) / 3.0)


@lru_cache(maxsize=1)
def _prototype() -> Tuple[np.ndarray, float, float]:
    """(window [512], synth_gain, analysis_phase).

    Preferred: the NORMATIVE ISO/IEC 11172-3 Table C.1 prototype
    (pqmf_window_iso.npz, produced by scripts/extract_iso_window.py from a
    conformant codec library's static table — spec data, not code), with
    the per-64-block sign alternation unfolded and analysis phase (n - 16)
    — the exact filterbank every third-party decoder inverts. An
    independent-decoder test (tests/test_mp3_native.py via libmpg123)
    showed the previous designed window cost 7-33 dB on real decoders
    while matched round trips looked fine.

    Fallbacks keep the module self-contained when the ISO artifact is
    absent: the DESIGNED window (scripts/design_pqmf.py, pqmf_window.npz,
    phase n + 16, >70 dB matched round trip), then an unpolished
    Kaiser-sinc (~30 dB)."""
    from pathlib import Path

    iso = Path(__file__).parent / "pqmf_window_iso.npz"
    if iso.exists():
        z = np.load(iso)
        return z["window"], float(z["synth_gain"]), float(z["analysis_phase"])
    path = Path(__file__).parent / "pqmf_window.npz"
    if path.exists():
        z = np.load(path)
        return z["window"], float(z["synth_gain"]), 16.0
    t = np.arange(512, dtype=np.float64) - 255.5
    fc = 1.1 / 64.0
    h = fc * np.sinc(fc * t) * np.kaiser(512, 7.0)
    n = np.arange(512.0)
    g = max(
        np.abs(np.fft.rfft(h * np.cos(np.pi * (2 * k + 1) * (n + 16) / 64.0), 16384)).max()
        for k in range(_SUBBANDS)
    )
    return h / g, 32.0 * g * g / 32.0, 16.0


_SYNTH_LAG = 512  # analysis+synthesis round-trip delay, absorbed here


@lru_cache(maxsize=1)
def _analysis_matrix() -> np.ndarray:
    """[32, 512]: row k = h[n] * cos(pi (2k+1)(n + phase) / 64) over
    newest-first windows (the causal-filter form of the ISO analysis;
    phase = -16 for the normative window, +16 for the designed one)."""
    h, _, phase = _prototype()
    n = np.arange(512, dtype=np.float64)
    k = np.arange(_SUBBANDS, dtype=np.float64)[:, None]
    return (h[None, :] * np.cos(np.pi * (2 * k + 1) * (n[None, :] + phase) / 64.0))


@lru_cache(maxsize=1)
def _synthesis_matrix() -> np.ndarray:
    """[32, 512]: row k = synth_gain * h[n] * cos(pi (2k+1)(n - phase) / 64)
    — the pseudo-QMF partner phase; adjacent-band alias terms cancel
    against the analysis bank (the adjoint does NOT cancel them)."""
    h, synth_gain, phase = _prototype()
    n = np.arange(512, dtype=np.float64)
    k = np.arange(_SUBBANDS, dtype=np.float64)[:, None]
    return synth_gain * (
        h[None, :] * np.cos(np.pi * (2 * k + 1) * (n[None, :] - phase) / 64.0)
    )


def analyze(pcm: np.ndarray) -> np.ndarray:
    """float PCM [T] (T multiple of 384) -> subband samples [T/32, 32]."""
    A = _analysis_matrix()
    T = len(pcm)
    padded = np.concatenate([np.zeros(511), pcm]).astype(np.float64)
    m = T // _SUBBANDS
    # Window for output m covers x[32m - 511 .. 32m], newest-first.
    idx = (np.arange(m)[:, None] * _SUBBANDS + 511) - np.arange(512)[None, :]
    return np.einsum("ms,ks->mk", padded[idx], A)


@lru_cache(maxsize=1)
def _iso_synth_tables() -> Tuple[np.ndarray, np.ndarray]:
    """(N [64, 32] matrixing cosines, D [512] synthesis window) for the
    normative ISO 11172-3 synthesis. D = 32 * C entry-wise; C is recovered
    from the stored prototype by re-folding the sign alternation."""
    h, _, _ = _prototype()
    c1 = h * (-1.0) ** (np.arange(512) // 64)
    N = np.cos(
        np.pi * (16 + np.arange(64))[:, None] * (2 * np.arange(_SUBBANDS)[None, :] + 1) / 64.0
    )
    return N, 32.0 * c1


def _synthesize_iso(sub: np.ndarray) -> np.ndarray:
    """ISO 11172-3 synthesis (V-FIFO matrixing + U selection + D window) —
    the exact algorithm third-party decoders run, verified 84 dB broadband
    round trip against the normative analysis (scripts/extract_iso_window
    .py). 16 zero frames are appended so every requested sample is fully
    reconstructed; the 512-sample pair delay is then dropped, aligning the
    round trip at lag 0 with unit gain."""
    N, D = _iso_synth_tables()
    M = sub.shape[0]
    sub = np.concatenate([sub, np.zeros((16, _SUBBANDS))], axis=0)
    V = np.zeros(1024)
    U = np.empty(512)
    out = np.empty((M + 16) * _SUBBANDS)
    for m in range(M + 16):
        V[64:] = V[:-64].copy()  # FIFO shift (overlapping views)
        V[:64] = N @ sub[m]
        for j in range(8):
            U[j * 64 : j * 64 + 32] = V[j * 128 : j * 128 + 32]
            U[j * 64 + 32 : j * 64 + 64] = V[j * 128 + 96 : j * 128 + 128]
        out[m * 32 : (m + 1) * 32] = (U * D).reshape(16, 32).sum(axis=0)
    return out[_SYNTH_LAG : _SYNTH_LAG + M * _SUBBANDS]


def synthesize(sub: np.ndarray) -> np.ndarray:
    """Subband synthesis of [M, 32] -> PCM [M*32], with the 512-sample
    round-trip delay absorbed so analyze->synthesize aligns at lag 0.

    With the normative ISO window loaded (analysis phase -16) this runs the
    spec's own V-buffer synthesis — bit-compatible with what mpg123/ffmpeg
    do; with the designed fallback window it runs the matched pseudo-QMF
    overlap-add pair."""
    _, _, phase = _prototype()
    if phase < 0:
        return _synthesize_iso(sub)
    B = _synthesis_matrix()
    M = sub.shape[0]
    out = np.zeros(M * _SUBBANDS + 512)
    contrib = np.einsum("mk,ku->mu", sub, B)
    for m in range(M):
        lo = m * _SUBBANDS
        out[lo : lo + 512] += contrib[m]
    return out[_SYNTH_LAG : _SYNTH_LAG + M * _SUBBANDS]


def _pick_bitrate(kbps: int, table: List[int]) -> int:
    valid = table[1:]
    best = min(valid, key=lambda b: abs(b - kbps))
    return table.index(best)


class _BitWriter:
    def __init__(self):
        self._acc = 0
        self._nbits = 0
        self._out = bytearray()

    def write(self, value: int, bits: int):
        self._acc = (self._acc << bits) | (value & ((1 << bits) - 1))
        self._nbits += bits
        while self._nbits >= 8:
            self._nbits -= 8
            self._out.append((self._acc >> self._nbits) & 0xFF)
        self._acc &= (1 << self._nbits) - 1

    def pad_to(self, nbytes: int):
        if self._nbits:
            self.write(0, 8 - self._nbits)
        while len(self._out) < nbytes:
            self._out.append(0)
        return bytes(self._out)


def _allocate_bits(scf_idx: np.ndarray, budget: int) -> np.ndarray:
    """Greedy waterfilling: [32] allocation in bits (0 or 2..15).

    Each first allocation costs 2*12 sample bits + 6 scf bits; each extra bit
    costs 12. Need metric = subband amplitude / 2^bits (quantization noise
    proxy)."""
    amp = _SCALEFACTORS[scf_idx]
    alloc = np.zeros(_SUBBANDS, dtype=np.int64)
    spent = 0
    while True:
        need = amp / np.power(2.0, alloc)
        need[alloc >= 15] = -np.inf
        sb = int(np.argmax(need))
        if not np.isfinite(need[sb]):
            break
        cost = 30 if alloc[sb] == 0 else 12
        if spent + cost > budget:
            # try the next-best candidates before giving up
            order = np.argsort(-need)
            for sb2 in order:
                cost2 = 30 if alloc[sb2] == 0 else 12
                if np.isfinite(need[sb2]) and spent + cost2 <= budget:
                    sb, cost = int(sb2), cost2
                    break
            else:
                break
        alloc[sb] += 2 if alloc[sb] == 0 else 1
        spent += cost
    return alloc


# ---------------------------------------------------------------------------
# Layer II (MPEG-2 LSF)
# ---------------------------------------------------------------------------

# Layer II/III LSF bitrates (kbps), index 1..14 (13818-3).
_BITRATES_L2_V2 = [0, 8, 16, 24, 32, 40, 48, 56, 64, 80, 96, 112, 128, 144, 160]
# MPEG-1 Layer II bitrates (kbps), index 1..14 (11172-3).
_BITRATES_L2_V1 = [0, 32, 48, 56, 64, 80, 96, 112, 128, 160, 192, 224, 256, 320, 384]

# Quantization classes: steps -> (bits per 3-sample granule, grouped, M).
# Grouped classes pack 3 base-`steps` digits into one codeword. The
# requantization constants are C = 2M/steps and D = 1/2 (grouped) or 1/M
# (ungrouped); dequant is s = scf * C * ((u - M)/M + D), the same affine
# family as Layer I (see decode below). The 7-step class (MPEG-1 tables
# only) is UNGROUPED with M=4 (C=8/7, D=1/4), reproducing ISO Table B.4.
_L2_CLASSES = {
    3: (5, True, 2), 5: (7, True, 4), 7: (9, False, 4), 9: (10, True, 8),
    15: (12, False, 8), 31: (15, False, 16), 63: (18, False, 32),
    127: (21, False, 64), 255: (24, False, 128), 511: (27, False, 256),
    1023: (30, False, 512), 2047: (33, False, 1024), 4095: (36, False, 2048),
    8191: (39, False, 4096), 16383: (42, False, 8192),
    32767: (45, False, 16384), 65535: (48, False, 32768),
}

# MPEG-2 LSF Layer II allocation table (one table for all bitrates):
# per-subband (allocation field width, steps per allocation index).
# The 4-bit ladder INCLUDES the 7-step (ungrouped) class at index 3 —
# cross-checked against the table data in a conformant third-party decoder
# after an independent-decoder test caught the ladder missing it (every
# allocation >= 3 in subbands 0-3 then shifted: self-consistent round trips
# passed while real decoders rendered garbage).
_L2_LSF_STEPS_LO = [0, 3, 5, 7, 9, 15, 31, 63, 127, 255, 511, 1023, 2047, 4095, 8191, 16383]
_L2_LSF_STEPS_MID = [0, 3, 5, 9, 15, 31, 63, 127]
_L2_LSF_STEPS_HI = [0, 3, 5, 9]
_L2_SBLIMIT = 30


def _l2_table(sb: int):
    if sb < 4:
        return 4, _L2_LSF_STEPS_LO
    if sb < 11:
        return 3, _L2_LSF_STEPS_MID
    return 2, _L2_LSF_STEPS_HI


# MPEG-1 Layer II allocation tables (ISO/IEC 11172-3 Tables B.2a-d),
# reconstructed from the standard's structure: step ladders per subband
# group and nbal field widths. B.2a (sblimit 27) and B.2b (sblimit 30)
# share the same per-group ladders and differ only in how many top
# subbands carry the 2-bit [0,3,5,65535] ladder; B.2c (8) / B.2d (12)
# are the low-bitrate tables.
_L2_V1_STEPS_02 = [0, 3, 7, 15, 31, 63, 127, 255, 511, 1023, 2047, 4095, 8191, 16383, 32767, 65535]
_L2_V1_STEPS_310 = [0, 3, 5, 7, 9, 15, 31, 63, 127, 255, 511, 1023, 2047, 4095, 8191, 65535]
_L2_V1_STEPS_1122 = [0, 3, 5, 7, 9, 15, 31, 65535]
_L2_V1_STEPS_TOP = [0, 3, 5, 65535]
_L2_V1_STEPS_C01 = [0, 3, 5, 9, 15, 31, 63, 127, 255, 511, 1023, 2047, 4095, 8191, 16383, 32767]
_L2_V1_STEPS_C2P = [0, 3, 5, 9, 15, 31, 63, 127]


def _l2_table_v1_ab(sb: int):
    if sb < 3:
        return 4, _L2_V1_STEPS_02
    if sb < 11:
        return 4, _L2_V1_STEPS_310
    if sb < 23:
        return 3, _L2_V1_STEPS_1122
    return 2, _L2_V1_STEPS_TOP


def _l2_table_v1_cd(sb: int):
    if sb < 2:
        return 4, _L2_V1_STEPS_C01
    return 3, _L2_V1_STEPS_C2P


# table id -> (sblimit, per-subband table fn)
_L2_V1_TABLES = {
    0: (27, _l2_table_v1_ab),
    1: (30, _l2_table_v1_ab),
    2: (8, _l2_table_v1_cd),
    3: (12, _l2_table_v1_cd),
}

# MPEG-1 Layer II table selection for MONO streams, by sampling rate and
# bitrate index (1..14). Matches the decoder-side mapping mainstream
# implementations use (11172-3 2.4.2.1: selection by per-channel bitrate).
_L2_V1_TABLE_SELECT = {
    44100: [0, 2, 2, 0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 1],
    48000: [0, 2, 2, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
    32000: [0, 3, 3, 0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 1],
}


def _l2_quant(x: np.ndarray, steps: int) -> np.ndarray:
    """Quantize normalized samples x in [-1, 1] to indices [0, steps-1] on
    the standard reconstruction grid s_hat = C((u - M)/M + D)."""
    bits3, grouped, M = _L2_CLASSES[steps]
    C = 2.0 * M / steps
    D = 0.5 if grouped else 1.0 / M
    u = np.round(M * (x / C - D) + M).astype(np.int64)
    return np.clip(u, 0, steps - 1)


def _l2_dequant(u: np.ndarray, steps: int) -> np.ndarray:
    bits3, grouped, M = _L2_CLASSES[steps]
    C = 2.0 * M / steps
    D = 0.5 if grouped else 1.0 / M
    return C * ((u.astype(np.float64) - M) / M + D)


def _l2_scfsi(s0: int, s1: int, s2: int):
    """(scfsi, transmitted scf indices): share scalefactors only on exact
    equality (conservative; the spec's lossy class merge is optional)."""
    if s0 == s1 == s2:
        return 0b10, [s0]
    if s0 == s1:
        return 0b01, [s0, s2]
    if s1 == s2:
        return 0b11, [s0, s1]
    return 0b00, [s0, s1, s2]


def _l2_allocate(
    amp: np.ndarray, scf_cost: np.ndarray, budget: int, sblimit: int, table
) -> List[int]:
    """Greedy waterfilling over allocation indices. amp [sblimit] = subband
    peak amplitude; scf_cost [sblimit] = scfsi+scalefactor bits if coded.
    Returns allocation index per subband."""
    alloc = [0] * sblimit
    spent = 0

    def gran_bits(sb, idx):
        if idx == 0:
            return 0
        _, steps_list = table(sb)
        return 12 * _L2_CLASSES[steps_list[idx]][0]

    while True:
        best, best_need = -1, 0.0
        for sb in range(sblimit):
            _, steps_list = table(sb)
            idx = alloc[sb]
            if idx + 1 >= len(steps_list):
                continue
            cost = gran_bits(sb, idx + 1) - gran_bits(sb, idx)
            if idx == 0:
                cost += int(scf_cost[sb])
            if spent + cost > budget:
                continue
            cur_steps = steps_list[idx] if idx else 1
            need = amp[sb] / cur_steps
            if need > best_need:
                best, best_need = sb, need
        if best < 0 or best_need <= 1e-9:
            break
        idx = alloc[best]
        cost = gran_bits(best, idx + 1) - gran_bits(best, idx)
        if idx == 0:
            cost += int(scf_cost[best])
        alloc[best] = idx + 1
        spent += cost
    return alloc


def _encode_layer2(
    pcm: np.ndarray, sample_rate: int, bitrate_kbps: int
) -> bytes:
    """MPEG Audio Layer II, mono. Frame = 1152 samples (36 granule rows of
    32 subbands = 12 three-sample granules per subband). Covers both the
    MPEG-2 LSF rates (single allocation table) and the MPEG-1 rates
    (per-(rate, bitrate) table selection over B.2a-d)."""
    version, sr_index = _RATES[sample_rate]
    if version == 0b11:  # MPEG-1
        br_index = _pick_bitrate(max(bitrate_kbps, 56), _BITRATES_L2_V1)
        bitrate = _BITRATES_L2_V1[br_index] * 1000
        sblimit, table = _L2_V1_TABLES[_L2_V1_TABLE_SELECT[sample_rate][br_index]]
    else:  # MPEG-2 LSF
        br_index = _pick_bitrate(max(bitrate_kbps, 48), _BITRATES_L2_V2)
        bitrate = _BITRATES_L2_V2[br_index] * 1000
        sblimit, table = _L2_SBLIMIT, _l2_table

    pcm = np.asarray(pcm, np.float64).reshape(-1)
    pcm = np.clip(pcm, -0.999, 0.999)
    frame_samples = 36 * _SUBBANDS  # 1152
    n_frames = max(1, math.ceil(len(pcm) / frame_samples))
    pcm = np.pad(pcm, (0, n_frames * frame_samples - len(pcm)))
    sub = analyze(pcm).reshape(n_frames, 36, _SUBBANDS)

    frame_bytes = (144 * bitrate) // sample_rate  # slot = 1 byte, no padding

    out = bytearray()
    for f in range(n_frames):
        s = sub[f]  # [36, 32]
        # Three scalefactors per subband, one per 12-sample part.
        parts = s.reshape(3, 12, _SUBBANDS)
        pmax = np.maximum(np.abs(parts).max(axis=1), 1e-10)  # [3, 32]
        scf_idx = np.clip(
            np.searchsorted(-_SCALEFACTORS, -pmax, side="right") - 1, 0, 62
        ).astype(np.int64)  # [3, 32]

        scfsi = np.zeros(sblimit, np.int64)
        txscf: List[List[int]] = []
        scf_cost = np.zeros(sblimit, np.int64)
        for sb in range(sblimit):
            si, tx = _l2_scfsi(*(int(scf_idx[p, sb]) for p in range(3)))
            scfsi[sb] = si
            txscf.append(tx)
            scf_cost[sb] = 2 + 6 * len(tx)

        alloc_field_bits = sum(table(sb)[0] for sb in range(sblimit))
        budget = frame_bytes * 8 - 32 - alloc_field_bits
        amp = np.abs(s[:, :sblimit]).max(axis=0)
        alloc = _l2_allocate(amp, scf_cost, budget, sblimit, table)

        w = _BitWriter()
        w.write(0x7FF, 11)
        w.write(version, 2)         # MPEG-1 / MPEG-2 LSF
        w.write(0b10, 2)            # Layer II
        w.write(1, 1)               # no CRC
        w.write(br_index, 4)
        w.write(sr_index, 2)
        w.write(0, 1)               # padding
        w.write(0, 1)               # private
        w.write(0b11, 2)            # mono
        w.write(0, 2)
        w.write(0, 1)
        w.write(1, 1)
        w.write(0, 2)

        for sb in range(sblimit):
            nbal, _ = table(sb)
            w.write(alloc[sb], nbal)
        for sb in range(sblimit):
            if alloc[sb]:
                w.write(int(scfsi[sb]), 2)
        for sb in range(sblimit):
            if alloc[sb]:
                for v in txscf[sb]:
                    w.write(int(v), 6)

        # Effective (dequant-side) scalefactor per part given scfsi sharing.
        eff_scf = np.empty((3, sblimit))
        for sb in range(sblimit):
            tx = txscf[sb]
            si = int(scfsi[sb])
            if si == 0b00:
                idxs = [tx[0], tx[1], tx[2]]
            elif si == 0b01:
                idxs = [tx[0], tx[0], tx[1]]
            elif si == 0b10:
                idxs = [tx[0], tx[0], tx[0]]
            else:
                idxs = [tx[0], tx[1], tx[1]]
            eff_scf[:, sb] = _SCALEFACTORS[idxs]

        for g in range(12):  # 12 granules of 3 samples
            part = g // 4
            for sb in range(sblimit):
                if not alloc[sb]:
                    continue
                _, steps_list = table(sb)
                steps = steps_list[alloc[sb]]
                bits3, grouped, _ = _L2_CLASSES[steps]
                x = s[3 * g : 3 * g + 3, sb] / eff_scf[part, sb]
                u = _l2_quant(x, steps)
                if grouped:
                    w.write(int(u[0] + steps * u[1] + steps * steps * u[2]), bits3)
                else:
                    nb = bits3 // 3
                    for ui in u:
                        w.write(int(ui), nb)
        out += w.pad_to(frame_bytes)
    return bytes(out)


_LSF_LAYER2_RATES = {16000, 22050, 24000}


def encode_mpeg_audio(
    pcm: np.ndarray, sample_rate: int, bitrate_kbps: int = 128,
    layer: Optional[int] = None,
) -> bytes:
    """Encode mono float PCM [-1, 1] to an MPEG Audio stream.

    layer=None auto-selects Layer II at every supported rate (MPEG-2 LSF
    variant at 16/22.05/24 kHz, MPEG-1 variant at 32/44.1/48 kHz — so the
    ElevenLabs-default `mp3_44100_128` gets Layer II); pass layer=1 for the
    Layer I fallback at the MPEG-1 rates."""
    if sample_rate not in _RATES:
        raise NotImplementedError(
            f"mpeg encoding unsupported at {sample_rate} Hz "
            f"(supported: {sorted(_RATES)})"
        )
    if layer is None:
        layer = 2
    if layer == 2:
        return _encode_layer2(pcm, sample_rate, bitrate_kbps)
    version, sr_index = _RATES[sample_rate]
    table = _BITRATES_V1 if version == 0b11 else _BITRATES_V2
    br_index = _pick_bitrate(max(bitrate_kbps, 64), table)
    bitrate = table[br_index] * 1000

    pcm = np.asarray(pcm, np.float64).reshape(-1)
    pcm = np.clip(pcm, -0.999, 0.999)
    n_frames = max(1, math.ceil(len(pcm) / _FRAME_SAMPLES))
    pcm = np.pad(pcm, (0, n_frames * _FRAME_SAMPLES - len(pcm)))
    sub = analyze(pcm).reshape(n_frames, _GRANULES, _SUBBANDS)

    # Layer I: slot = 4 bytes; slots/frame = 12 * bitrate / fs (+ padding
    # frame by frame to hit the exact rate — we use the unpadded floor).
    slots = (12 * bitrate) // sample_rate
    frame_bytes = int(slots) * 4

    out = bytearray()
    for f in range(n_frames):
        s = sub[f]  # [12, 32]
        amax = np.abs(s).max(axis=0)  # [32]
        # tightest scalefactor >= amax (table is decreasing in the index)
        scf_idx = np.clip(
            np.searchsorted(-_SCALEFACTORS, -np.maximum(amax, 1e-10), side="right") - 1,
            0, 62,
        ).astype(np.int64)

        budget = frame_bytes * 8 - 32 - _SUBBANDS * 4
        alloc = _allocate_bits(scf_idx, budget)

        w = _BitWriter()
        w.write(0x7FF, 11)          # sync
        w.write(version, 2)
        w.write(0b11, 2)            # Layer I
        w.write(1, 1)               # no CRC
        w.write(br_index, 4)
        w.write(sr_index, 2)
        w.write(0, 1)               # padding
        w.write(0, 1)               # private
        w.write(0b11, 2)            # mono
        w.write(0, 2)               # mode extension
        w.write(0, 1)               # copyright
        w.write(1, 1)               # original
        w.write(0, 2)               # no emphasis

        for sb in range(_SUBBANDS):
            w.write(int(alloc[sb]) - 1 if alloc[sb] else 0, 4)
        for sb in range(_SUBBANDS):
            if alloc[sb]:
                w.write(int(scf_idx[sb]), 6)
        scf = _SCALEFACTORS[scf_idx]
        for g in range(_GRANULES):
            for sb in range(_SUBBANDS):
                nb = int(alloc[sb])
                if not nb:
                    continue
                x = s[g, sb] / scf[sb]  # in [-1, 1]
                a = (float(1 << nb) - 1.0) / float(1 << nb)
                b = -1.0 / float(1 << nb)
                q = math.floor((a * x + b) * (1 << (nb - 1))) + (1 << (nb - 1))
                w.write(min(max(q, 0), (1 << nb) - 1), nb)
        out += w.pad_to(frame_bytes)
    return bytes(out)


# ---------------------------------------------------------------------------
# Decoder — test oracle (parses the real bitstream; matched-window synthesis)
# ---------------------------------------------------------------------------


class _BitReader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0  # in bits

    def read(self, bits: int) -> int:
        v = 0
        for _ in range(bits):
            byte = self.data[self.pos >> 3]
            v = (v << 1) | ((byte >> (7 - (self.pos & 7))) & 1)
            self.pos += 1
        return v


def _decode_layer2_frame(r: "_BitReader", sblimit: int, table) -> np.ndarray:
    """Parse one Layer II frame body (after the 32-bit header) ->
    subband samples [36, 32]. `sblimit`/`table` select the LSF or
    MPEG-1 allocation table the encoder used (derived from the header)."""
    alloc = []
    for sb in range(sblimit):
        nbal, steps_list = table(sb)
        alloc.append(steps_list[r.read(nbal)])
    scfsi = [r.read(2) if alloc[sb] else 0 for sb in range(sblimit)]
    scf = np.ones((3, _SUBBANDS))
    for sb in range(sblimit):
        if not alloc[sb]:
            continue
        si = scfsi[sb]
        n_tx = {0b00: 3, 0b01: 2, 0b10: 1, 0b11: 2}[si]
        tx = [r.read(6) for _ in range(n_tx)]
        if si == 0b00:
            idxs = tx
        elif si == 0b01:
            idxs = [tx[0], tx[0], tx[1]]
        elif si == 0b10:
            idxs = [tx[0]] * 3
        else:
            idxs = [tx[0], tx[1], tx[1]]
        scf[:, sb] = _SCALEFACTORS[idxs]
    s = np.zeros((36, _SUBBANDS))
    for g in range(12):
        part = g // 4
        for sb in range(sblimit):
            steps = alloc[sb]
            if not steps:
                continue
            bits3, grouped, _ = _L2_CLASSES[steps]
            if grouped:
                v = r.read(bits3)
                u = np.array([v % steps, (v // steps) % steps, v // (steps * steps)])
            else:
                nb = bits3 // 3
                u = np.array([r.read(nb) for _ in range(3)])
            s[3 * g : 3 * g + 3, sb] = _l2_dequant(u, steps) * scf[part, sb]
    return s


def decode_mpeg_audio(data: bytes) -> Tuple[np.ndarray, int]:
    """Parse Layer I / LSF Layer II mono frames -> (PCM float64, rate)."""
    rates_v1 = {0: 44100, 1: 48000, 2: 32000}
    rates_v2 = {0: 22050, 1: 24000, 2: 16000}
    pos = 0
    subbands: List[np.ndarray] = []
    sample_rate = None
    while pos + 4 <= len(data):
        r = _BitReader(data[pos:])
        assert r.read(11) == 0x7FF, "lost sync"
        version = r.read(2)
        layer_bits = r.read(2)
        r.read(1)
        br_index = r.read(4)
        sr_index = r.read(2)
        r.read(10)  # padding+private+mode+mode_ext+copyright+original+emphasis
        sample_rate = (rates_v1 if version == 0b11 else rates_v2)[sr_index]
        if layer_bits == 0b11:  # Layer I
            table = _BITRATES_V1 if version == 0b11 else _BITRATES_V2
            frame_bytes = (12 * table[br_index] * 1000 // sample_rate) * 4
            alloc = []
            for _ in range(_SUBBANDS):
                code = r.read(4)
                alloc.append(code + 1 if code else 0)
            scf = np.ones(_SUBBANDS)
            for sb in range(_SUBBANDS):
                if alloc[sb]:
                    scf[sb] = _SCALEFACTORS[r.read(6)]
            s = np.zeros((_GRANULES, _SUBBANDS))
            for g in range(_GRANULES):
                for sb in range(_SUBBANDS):
                    nb = alloc[sb]
                    if not nb:
                        continue
                    q = r.read(nb)
                    s3 = (q - (1 << (nb - 1))) / float(1 << (nb - 1))
                    s2 = (s3 + 2.0 ** (1 - nb)) * (
                        float(1 << nb) / (float(1 << nb) - 1.0)
                    )
                    s[g, sb] = s2 * scf[sb]
        elif layer_bits == 0b10:  # Layer II
            if version == 0b10:  # LSF
                frame_bytes = (144 * _BITRATES_L2_V2[br_index] * 1000) // sample_rate
                s = _decode_layer2_frame(r, _L2_SBLIMIT, _l2_table)
            else:  # MPEG-1: table selection must mirror the encoder's
                frame_bytes = (144 * _BITRATES_L2_V1[br_index] * 1000) // sample_rate
                sblimit, table = _L2_V1_TABLES[
                    _L2_V1_TABLE_SELECT[sample_rate][br_index]
                ]
                s = _decode_layer2_frame(r, sblimit, table)
        else:
            raise AssertionError(f"unsupported layer bits {layer_bits:#b}")
        subbands.append(s)
        pos += frame_bytes
    assert subbands, "no frames"
    return synthesize(np.concatenate(subbands, axis=0)), sample_rate
