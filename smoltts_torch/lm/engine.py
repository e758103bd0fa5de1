"""Continuous-batching decode engine: B fixed slots, per-stream state.

A fixed batch of B decode slots whose KV caches, positions, finished flags
and Mimi vocoder states live on the card. Streams are admitted into free
slots (prefill into a fresh sub-state, scattered into the slots), stepped
together every 80 ms frame, and evicted on <|im_end|> or at their frame
budget. The semantics are the JAX package's (`smoltts_tpu/lm/engine.py`);
where the port differs:

- The state is updated in place (lm/decode.py), so a dispatched step's
  outputs are snapshotted when it is dispatched: on the card, copies into
  pinned host buffers enqueued on the step's stream, then a CUDA event.
  `fetch` waits on its own records' events and enqueues no device work;
  only the thread that dispatches launches kernels.
- Randomness is a `torch.Generator` on the engine's device, where the JAX
  engine splits its key: sampled streams match JAX in distribution only,
  greedy streams token for token.
- The vocoder state is stepped in place and, on the card, as a replayed
  CUDA graph (codec/graph.py `VocoderGraphs`): the engine's B-slot state
  and one sub-state per admission size, reset in place before each
  admission's first vocode, each keep their addresses for good.
- With the vocoder, the LM state is stepped in place too and, on the card
  without a mesh, the LM frame replays a CUDA graph per attend bucket
  (lm/graph.py `LMFrameGraphs`): admissions, freed slots and flushes write
  into the engine's state, which keeps its addresses for good.
- `warm` runs every program once on a throwaway state of the engine's
  shapes, so the kernels are built and loaded and cuDNN has chosen its
  algorithms before the first request, and captures the vocoder's graphs
  and the LM frame's.
- `shard` lays the engine over a `torch.distributed` mesh
  (parallel/serving.py) as a leader and followers: rank 0 runs the host
  logic below unchanged and broadcasts a small plan per dispatch (freed
  slots, admissions, the step's K, bucket and flush); every other rank runs
  `follow()` and executes the plans until `release_followers()`. Each rank
  steps its own slots; a step's outputs are gathered over the data axis
  onto every rank before the leader's snapshot.
- Fetched frames are numpy arrays; f32-format PCM is float32 also for a
  bf16 vocoder (numpy has no bfloat16).

Host-side, `DecodeEngine` is synchronous (`submit` + `step`); `EngineLoop`
drives it from a dispatch thread and fetch threads that fan frames out to
per-stream queues.
"""

from __future__ import annotations

import collections
import itertools
import queue
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from smoltts_torch import resolve_device
from smoltts_torch.config import DualARConfig
from smoltts_torch.lm.decode import decode_frame, init_decode_state, prefill
from smoltts_torch.lm.generate import pad_prompts
from smoltts_torch.lm.samplers import GenerationSettings
from smoltts_torch.tokenizer import TokenConfig
from smoltts_torch.utils.profiling import SPANS, TimedLock, lock_counters


@dataclass
class StreamHandle:
    stream_id: int
    slot: int
    frames_emitted: int = 0  # fetched + accounted frames
    frames_dispatched: int = 0  # frames enqueued on the device (runs ahead)
    max_frames: int = 1024
    done: bool = False


class Record(NamedTuple):
    """One dispatched device step awaiting its result fetch.

    `urgent` marks admission records: they hold a just-admitted stream's
    FIRST frame, so `take_due` releases them at once instead of holding them
    `inflight` dispatches behind. Accounting one ahead of older records is
    safe: it is the first record that mentions its streams. A later record
    must not overtake it, or a stream's second frame would be taken for its
    first (`EngineLoop._account_in_order`)."""

    payload: tuple  # host snapshots: (codes, is_audio, finished, slow, pcm or None)
    rows: list  # [(row index in payload, stream id)]
    n_frames: int  # K: the payload is frame-major [K, B, ...]
    urgent: bool = False
    # Dispatch ordinal of every record, urgent ones included.
    seq: int = 0
    # fetch_start / fetch_end stamps written by fetch(), folded into the
    # engine's timings for admission records (see pop_timing).
    meta: dict = None
    # The card's event after the snapshot copies (None on the CPU).
    event: Optional[object] = None


def _stacked(tensors: list) -> torch.Tensor:
    """K tensors stacked on a new axis 0; at K = 1 a view (no device op)."""
    return tensors[0][None] if len(tensors) == 1 else torch.stack(tensors)


def _frame_major(outs: list) -> tuple:
    """(codes, is_audio, finished, slow) [K, B, ...] from K frames' outputs
    (`FrameOutput`s or `StreamStepOutput`s)."""
    return tuple(_stacked([getattr(o, f) for o in outs])
                 for f in ("audio_codes", "is_audio", "finished", "slow_token"))


class DecodeEngine:
    """Slot-based continuous batching over prefill and the frame steps."""

    def __init__(
        self,
        params,
        cfg: DualARConfig,
        token_cfg: TokenConfig,
        settings: GenerationSettings,
        num_slots: int = 32,
        max_seq_len: Optional[int] = None,
        kv_dtype=torch.bfloat16,
        generator: Optional[torch.Generator] = None,
        prompt_bucket: int = 64,
        mimi_params=None,
        mimi_cfg=None,
        attend_buckets: Optional[List[int]] = None,
        inflight: int = 2,
        fetch_every: int = 1,
        emit_format: str = "f32",
        chunk_frames: int = 1,
        tail_len: int = 128,
        admit_sizes: Optional[List[int]] = None,
        device=None,
    ):
        from smoltts_torch.codec.graph import VocoderGraphs
        from smoltts_torch.lm.graph import LMFrameGraphs
        from smoltts_torch.lm.pipeline import flush_cadence, make_flush_step
        from smoltts_torch.ops.quant import fuse_decode_params, fuse_mimi_decode_params

        self.device = resolve_device(device)
        # chunk_frames > 1: with the vocoder attached, one dispatch advances K
        # frames (make_chunk_step); admissions are taken at the top of every
        # dispatch, so a queued prompt waits at most the in-flight records.
        self.chunk_frames = max(1, int(chunk_frames))
        # emit_format: the PCM representation of fetched frames, made on the
        # device: "f32", "int16" (what the stream route serves; 2x fewer bytes
        # to the host) or "ulaw" (G.711 mu-law, 4x fewer; io/g711.py).
        if emit_format not in ("f32", "int16", "ulaw"):
            raise ValueError(f"emit_format {emit_format!r}")
        self.emit_format = emit_format
        self.params = fuse_decode_params(params)  # bit-exact (ops/quant.py)
        self.cfg = cfg
        self.token_cfg = token_cfg
        self.settings = settings
        self.num_slots = num_slots
        self.S = max_seq_len or cfg.max_seq_len
        self.prompt_bucket = prompt_bucket
        self.kv_dtype = kv_dtype
        self.tail_len = tail_len
        # Admission batch sizes (an admission of 7 over {1, 2, 4} runs as
        # 4 + 2 + 1); 1 is always allowed, so any batch admits.
        if admit_sizes is None:
            admit_sizes, n = [], 1
            while n <= num_slots:
                admit_sizes.append(n)
                n *= 2
        self.admit_sizes = sorted({1} | {int(s) for s in admit_sizes if s <= num_slots})
        self.generator = (generator if generator is not None
                          else torch.Generator(device=self.device).manual_seed(0))

        # Length bucketing: each step attends the smallest bucket that covers
        # every LIVE slot's positions; exact, since reads past pos are masked.
        if attend_buckets is None:
            attend_buckets, b = [], 256
            while b < self.S:
                attend_buckets.append(b)
                b *= 2
        self.attend_buckets = sorted({min(int(b), self.S) for b in attend_buckets} | {self.S})
        # Host mirror of each live slot's cache position: admission seeds it
        # with the true prompt length, every dispatched frame adds 1. The
        # bucket is chosen from it, with no read of the device.
        self._slot_pos = np.zeros((num_slots,), np.int64)
        self.last_attend_limit: Optional[int] = None

        # Records are fetched `inflight` dispatches behind, `fetch_every` at a
        # time (the device keeps working through the fetch).
        self.inflight = max(0, int(inflight))
        self.fetch_every = max(1, int(fetch_every))
        self._queue: "collections.deque" = collections.deque()

        # Set by shard(): the mesh the steps run on (its model axis folded away
        # without tensor parallelism), and the generator admissions draw from
        # (alike on every rank, so every rank prefills the same first frames).
        self.mesh = None
        self._admit_generator = self.generator
        self.state = self._fresh_state()
        self._slot_ids = torch.arange(num_slots, device=self.device)
        # Slots freed since the last dispatch, marked finished on the device at
        # the top of the next one, by the dispatching thread (a stream that
        # ends on <|im_end|> is released by `account`, on a fetch thread).
        self._to_mark: List[int] = []
        self._ids = itertools.count()
        # The next record's dispatch ordinal, and the ordinals dispatched but
        # not yet accounted (an EngineLoop accounts a non-urgent record only
        # once every record dispatched before it has been).
        self._seq = 0
        self._unaccounted: set = set()
        self._free: List[int] = list(range(num_slots))
        self._streams: Dict[int, StreamHandle] = {}
        self._slot_to_stream: Dict[int, int] = {}
        self._pending: List[Tuple[int, np.ndarray]] = []
        # Dispatch/fetch economics: fetch_calls per dispatched frame stay
        # ~1/chunk_frames in steady state. frame_steps counts the frames the
        # whole batch advanced, admissions the prefill dispatches. An
        # EngineLoop adds its dispatcher's seconds in dispatch_step
        # (dispatch_s) and asleep at the max_ahead gate with streams live
        # (gate_wait_s), and its lock's seconds waited and held and its
        # acquisitions per role (utils/profiling.py TimedLock).
        self.stats = {
            "dispatches": 0,
            "frames_dispatched": 0,
            "fetch_calls": 0,
            "records_fetched": 0,
            "urgent_fetched": 0,
            "frame_steps": 0,
            "admissions": 0,
            "dispatch_s": 0.0,
            "gate_wait_s": 0.0,
            **lock_counters(),
        }
        # Per-stream first-audio latency stamps (submit -> admit -> fetch_start
        # -> fetch_end -> first), kept until pop_timing() or cap eviction.
        self.timings: "collections.OrderedDict" = collections.OrderedDict()
        self._timings_cap = 4096

        # Optional slot-batched vocoder: the Mimi streaming state lives on the
        # same slots, and frames are vocoded in the same dispatch.
        self.mimi_params = None if mimi_params is None else fuse_mimi_decode_params(mimi_params)
        self.mimi_cfg = mimi_cfg
        self.mimi_state = None if mimi_params is None else self._fresh_mimi_state()
        # The vocoder's graphs: the B-slot state's and one per admission size,
        # over the sub-states each admission vocodes its first frames on.
        self._vocoder = VocoderGraphs(max_graphs=len(self.admit_sizes) + 1)
        self._admit_mimi: Dict[int, object] = {}
        # The LM frame's graphs over the engine's state, one per attend bucket.
        self._lm_frame = LMFrameGraphs(max_graphs=len(self.attend_buckets))
        # The frame loops (lm/pipeline.py frame_loop), by (K, attend limit).
        self._steps: Dict[Tuple[int, int], callable] = {}
        # Ring-tail flush cadence of the LM (and codec transformer) tails.
        self._flush_step = make_flush_step(device=self.device)
        self._since_flush = 0
        self._flush_every = flush_cadence(self.state, self.mimi_state)
        # A chunk's K frames all land in the ring tails before the next flush.
        self.chunk_frames = min(self.chunk_frames, max(1, self._flush_every))

    # ------------------------------------------------------------------

    def _fresh_state(self):
        """All slots idle (finished)."""
        state = init_decode_state(self.cfg, self.num_slots, self.S, dtype=self.kv_dtype,
                                  tail_len=self.tail_len, device=self.device, mesh=self.mesh)
        return state._replace(finished=torch.ones_like(state.finished))

    def _fresh_mimi_state(self):
        """kv8 (kv_dtype int8) applies to the codec's KV ring only; its conv
        buffers are then bf16."""
        from smoltts_torch.codec.mimi import decode_stream_init

        kv8 = self.kv_dtype == torch.int8
        return decode_stream_init(self.mimi_cfg, self.num_slots,
                                  dtype=torch.bfloat16 if kv8 else self.kv_dtype,
                                  kv_dtype=torch.int8 if kv8 else None, device=self.device,
                                  mesh=self.mesh)

    def shard(self, mesh, tensor_parallel: bool = False, shard_tables: bool = False):
        """Lay the engine's trees out over `mesh` (parallel/mesh.py,
        parallel/serving.py): decode slots and the vocoder's per-slot state
        split over `data`; the slow trunk split Megatron-style over `model`
        when tensor_parallel, else the params replicate. Call on every rank
        BEFORE warm()/submit(); then rank 0 leads (submit, step,
        dispatch_step, EngineLoop) and every other rank calls `follow()`.
        Generators: the steps draw from the engine's seed plus the data
        coordinate (the model axis draws alike), admissions from the seed."""
        from smoltts_torch.parallel.serving import shard_serving

        if self.mesh is not None or self._streams or self._queue:
            raise RuntimeError("DecodeEngine.shard: call once, before submit()")
        if self.num_slots % mesh.n_data:
            raise ValueError(f"DecodeEngine.shard: {self.num_slots} slots do not split over "
                             f"a data axis of {mesh.n_data}")
        if mesh.device is not None and torch.device(mesh.device) != self.device:
            raise ValueError(f"DecodeEngine.shard: the mesh's device {mesh.device} is not the "
                             f"engine's {self.device}")
        self.params, self.state, self.mimi_params, self.mimi_state = shard_serving(
            self.params, self.state, mesh, mimi_params=self.mimi_params,
            mimi_state=self.mimi_state, tensor_parallel=tensor_parallel,
            shard_tables=shard_tables, cfg=self.cfg)
        self.mesh = mesh if tensor_parallel else mesh.data_only()
        seed = self.generator.initial_seed()
        self.generator = torch.Generator(device=self.device).manual_seed(seed + mesh.data)
        self._admit_generator = torch.Generator(device=self.device).manual_seed(seed)
        self._steps.clear()
        return self

    @property
    def is_leader(self) -> bool:
        """Whether this rank runs the host logic (always, unsharded)."""
        return self.mesh is None or torch.distributed.get_rank() == 0

    def _owned(self, slots: List[int]) -> Tuple[List[int], List[int]]:
        """(positions in `slots` of the slots this rank holds, their local
        indices)."""
        if self.mesh is None:
            return list(range(len(slots))), list(slots)
        n_local = self.num_slots // self.mesh.n_data
        lo = self.mesh.data * n_local
        pairs = [(i, s - lo) for i, s in enumerate(slots) if lo <= s < lo + n_local]
        return [i for i, _ in pairs], [s for _, s in pairs]

    @property
    def active(self) -> int:
        return len(self._streams)

    def _emit_pcm(self, pcm: torch.Tensor) -> torch.Tensor:
        """The fetched PCM representation per emit_format, made on the device.
        int16 truncates toward zero after clip * 32767, as JAX's astype."""
        if self.emit_format == "int16":
            return (torch.clamp(pcm.float(), -1.0, 1.0) * 32767.0).to(torch.int16)
        if self.emit_format == "ulaw":
            from smoltts_torch.io.g711 import ulaw_encode

            return ulaw_encode(pcm)
        return pcm.float()

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        """A host array on the engine's device, with no wait on the device's
        queue (a copy from pageable memory would synchronize the stream)."""
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def _snapshot(self, tensors) -> Tuple[tuple, Optional[object]]:
        """Host copies of a step's outputs as they are now in stream order,
        and the event that marks them complete (None on the CPU, where the
        copies are done on return)."""
        if self.device.type != "cuda":
            return tuple(None if t is None else t.clone() for t in tensors), None
        host = []
        for t in tensors:
            if t is None:
                host.append(None)
                continue
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            h.copy_(t, non_blocking=True)
            host.append(h)
        event = torch.cuda.Event(blocking=True)
        event.record(torch.cuda.current_stream(self.device))
        return tuple(host), event

    def _step(self, K: int, lim: int):
        """K frames, each vocoded, attending up to `lim` (lm/pipeline.py
        frame_loop)."""
        from smoltts_torch.lm.pipeline import frame_loop

        step = self._steps.get((K, lim))
        if step is None:
            graphed = self._lm_frame.graphed(self.params, self.cfg, self.settings, self.state,
                                             self.mesh)
            step = self._steps[K, lim] = frame_loop(
                self.cfg, self.token_cfg, self.settings, self.mimi_cfg, K, attend_limit=lim,
                mesh=self.mesh, vocoder=self._vocoder,
                lm_frame=self._lm_frame if graphed else None)
        return step

    def _flush(self, state, mstate):
        """Flush the LM and codec ring tails -> (state', mstate')."""
        with SPANS.span("engine.flush"):
            return self._flush_step(state, mstate)

    def _advance(self, state, mstate, K: int, lim: int, generator):
        """K frames for every slot (K is 1 without the vocoder) -> (state',
        mstate', (codes, is_audio, finished, slow), pcm or None), frame-major
        [K, B, ...]."""
        with SPANS.span("engine.advance"):
            if mstate is None:
                state, out = decode_frame(self.params, self.cfg, self.token_cfg, self.settings,
                                          state, generator, attend_limit=lim, mesh=self.mesh)
                return state, None, _frame_major([out]), None
            with SPANS.span("step.stream" if K == 1 else "step.chunk"):
                state, mstate, outs = self._step(K, lim)(self.params, self.mimi_params, state,
                                                         mstate, generator)
            pcm = self._emit_pcm(_stacked([o.pcm for o in outs]))
            return state, mstate, _frame_major(outs), pcm

    def _admit(self, state, mstate, slots: List[int], prompt: np.ndarray, lens: np.ndarray,
               generator):
        """Prefill n prompts into a fresh n-slot sub-state and scatter it into
        `slots` of `state` (in place), every field JAX's _admit_fn sets; with
        the vocoder, vocode the first frames on the n-slot streaming
        sub-state, reset to zero, and scatter it into `mstate`. Returns
        (state, first FrameOutput, PCM). Sharded, every rank prefills and
        vocodes all n prompts and scatters the rows of the slots it holds."""
        from smoltts_torch.codec.mimi import reset_stream_slots, scatter_stream_state
        from smoltts_torch.lm.decode import scatter_decode_state
        from smoltts_torch.parallel.serving import take_slots

        with SPANS.span("engine.admit"):
            n = len(slots)
            rows, local = self._owned(slots)
            idx = self._upload(np.asarray(local, np.int64))
            pick = None if rows == list(range(n)) else self._upload(np.asarray(rows, np.int64))
            if mstate is not None and rows:
                reset_stream_slots(mstate, idx)
            sub = init_decode_state(self.cfg, n, self.S, dtype=state.k.dtype, device=self.device,
                                    mesh=None if self.mesh is None else self.mesh.model_only())
            sub, out = prefill(self.params, self.cfg, self.token_cfg, self.settings, sub,
                               self._upload(prompt), self._upload(lens), generator, mesh=self.mesh)
            if rows:
                scatter_decode_state(state, sub if pick is None else take_slots(sub, pick), idx)
            pcm = None
            if mstate is not None:
                msub = self._admit_mimi_state(n, mstate)
                msub, pcm = self._vocoder(self.mimi_params, self.mimi_cfg, msub,
                                          out.audio_codes[:, :, None])
                pcm = self._emit_pcm(pcm)
                if rows:
                    scatter_stream_state(mstate, msub if pick is None else take_slots(msub, pick),
                                         idx)
            return state, out, pcm

    def _admit_mimi_state(self, n: int, like):
        """The n-slot streaming sub-state of admissions of n, reset in place
        to `decode_stream_init`'s values (made at the first)."""
        from smoltts_torch.codec.mimi import decode_stream_init, reset_stream_state

        msub = self._admit_mimi.get(n)
        if msub is None:
            kv8 = like.transformer.k_scale is not None
            msub = self._admit_mimi[n] = decode_stream_init(
                self.mimi_cfg, n, dtype=like.upsample_tail.dtype,
                kv_dtype=torch.int8 if kv8 else None, device=self.device)
            return msub
        return reset_stream_state(msub)

    @torch.no_grad()
    def warm(self, prompt_len: Optional[int] = None, buckets: Optional[List[int]] = None,
             parallel: int = 0, progress=None) -> None:
        """Run every program a serving run can hit once: admission at each of
        `admit_sizes` (with the admission vocode, whose graph it captures),
        the LM frame at each attend bucket, and the flush, on a throwaway
        state of the engine's shapes; then capture the vocoder step's graph
        over the engine's streaming state and, with the vocoder, the LM
        frame's graph at each attend bucket over the engine's state, which a
        capture does not advance. The engine's state is not touched.
        `buckets` restricts the attend buckets (default all).
        `parallel` is accepted for the JAX signature: nothing here compiles
        concurrently. `progress` is an optional callable(str). Sharded, the
        leader's call runs it on every rank."""
        del parallel
        T = prompt_len or self.prompt_bucket
        if self.mesh is not None:
            self.mesh.broadcast_object({"warm": (T, buckets)})
        self._warm(T, buckets, progress or (lambda s: None))

    def _warm(self, T: int, buckets: Optional[List[int]], note) -> None:
        state = self._fresh_state()
        mstate = None if self.mimi_state is None else self._fresh_mimi_state()
        gen = torch.Generator(device=self.device).manual_seed(0)
        for n in self.admit_sizes:
            prompt = np.zeros((n, self.cfg.num_rows, T), np.int32)
            state, _, _ = self._admit(state, mstate, list(range(n)), prompt,
                                      np.full((n,), T, np.int32), gen)
            note(f"warm admit n={n}")
        if mstate is not None:
            codes = torch.zeros((mstate.upsample_tail.shape[0], self.cfg.num_codebooks, 1),
                                dtype=torch.int32, device=self.device)
            self._vocoder.capture(self.mimi_params, self.mimi_cfg, self.mimi_state, codes)
            note("warm vocoder graph")
        # The LM frame alone: a frame or chunk step would vocode the
        # throwaway state, whose graph no serving step replays.
        for lim in buckets if buckets is not None else self.attend_buckets:
            state, _, _, _ = self._advance(state, None, 1, lim, gen)
            state, mstate = self._flush(state, mstate)
            note(f"warm step bucket={lim}")
            if mstate is not None:
                self._lm_frame.capture(self.params, self.cfg, self.token_cfg, self.settings,
                                       self.state, attend_limit=lim, mesh=self.mesh)
                note(f"warm LM frame graph bucket={lim}")
        note("warm flush")
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def submit(self, prompt: np.ndarray, max_frames: Optional[int] = None) -> int:
        """Queue a [num_rows, T] prompt; returns a stream id."""
        sid = next(self._ids)
        self._pending.append((sid, np.asarray(prompt, np.int32)))
        h = StreamHandle(stream_id=sid, slot=-1)
        h.max_frames = max_frames or self.settings.max_new_tokens
        self._streams[sid] = h
        self.timings[sid] = {"submit": time.monotonic()}
        while len(self.timings) > self._timings_cap:
            self.timings.popitem(last=False)
        return sid

    def drain_timings(self) -> List[dict]:
        """Pop every COMPLETED first-audio decomposition (see pop_timing)."""
        out = []
        for sid in [s for s, t in list(self.timings.items()) if "first" in t]:
            t = self.pop_timing(sid)
            if t is not None:
                out.append(t)
        return out

    def pop_timing(self, sid: int) -> Optional[dict]:
        """First-audio latency decomposition of a served stream, seconds:
        `queue_wait` (submit -> prefill dispatched), `dispatch_wait` (->
        the urgent fetch begins: device execution plus fetcher pickup),
        `fetch` (the wait for the record and its copy to the host), `deliver`
        (-> frame accounted), and `total`. None until the first frame has
        been accounted."""
        t = self.timings.get(sid)
        if not t or "first" not in t:
            return None
        self.timings.pop(sid, None)
        return {
            "queue_wait": t["admit"] - t["submit"],
            "dispatch_wait": t["fetch_start"] - t["admit"],
            "fetch": t["fetch_end"] - t["fetch_start"],
            "deliver": t["first"] - t["fetch_end"],
            "total": t["first"] - t["submit"],
        }

    # ------------------------------------------------------------------

    def _plan_admissions(self) -> list:
        """Take queued prompts into free slots: [(slots, padded prompt,
        lengths, stream ids)], batch sizes quantized to `admit_sizes`."""
        admits = []
        while self._pending and self._free:
            n = min(len(self._pending), len(self._free))
            n = max(s for s in self.admit_sizes if s <= n)  # largest allowed
            batch = [self._pending.pop(0) for _ in range(n)]
            slots = [self._free.pop(0) for _ in range(n)]
            for (sid, _), slot in zip(batch, slots):
                self._streams[sid].slot = slot
                self._slot_to_stream[slot] = sid
            prompt, lens = pad_prompts([p for _, p in batch], pad_to_multiple=self.prompt_bucket)
            self._slot_pos[slots] = lens  # true lengths: reads past pos are masked
            admits.append((slots, prompt, lens, [sid for sid, _ in batch]))
        return admits

    def _enqueue(self, rec: Record) -> None:
        rec = rec._replace(seq=self._seq)
        self._seq += 1
        self._unaccounted.add(rec.seq)
        self._queue.append(rec)

    def _bookkeep(self, sid: int, frame: dict) -> Optional[dict]:
        """Account one fetched frame; None = drop (the stream was already
        released: the device ran ahead of the host's lagged eviction)."""
        h = self._streams.get(sid)
        if h is None or h.done:
            return None
        h.frames_emitted += 1
        if frame["finished"] or h.frames_emitted >= h.max_frames:
            h.done = True
            frame["finished"] = True
            self._release(sid)
        return frame

    def _free_slot(self, h: StreamHandle) -> None:
        """Return a stream's slot to the pool; it is marked finished on the
        device before the next dispatch's admissions (`_mark_freed`). A
        budget-limited stream's slot frees when its last frame is DISPATCHED;
        the handle stays until its frames are fetched (records map rows to
        stream ids, so a reused slot is unambiguous)."""
        if h.slot < 0:
            return
        self._slot_to_stream.pop(h.slot, None)
        self._free.append(h.slot)
        self._to_mark.append(h.slot)
        h.slot = -1

    def _mark_freed(self, slots: Optional[List[int]] = None) -> None:
        """Mark freed slots (default: those freed since the last dispatch)
        finished on the device, so they stop consuming sampler work: one
        index on the device per slot, no host sync. Runs before admission,
        which may reuse them."""
        if slots is None:
            slots, self._to_mark = self._to_mark, []
        _, local = self._owned(slots)
        for slot in local:
            self.state.finished.index_fill_(0, self._slot_ids[slot : slot + 1], True)

    @staticmethod
    def fetch(records: list) -> list:
        """The records' outputs as numpy arrays: waits on each record's own
        event (no lock, no device work), so it can run outside the engine
        lock, concurrently with dispatching."""
        t0 = time.monotonic()
        for r in records:
            if r.event is not None:
                r.event.synchronize()
        out = [tuple(None if t is None else t.numpy() for t in r.payload) for r in records]
        t1 = time.monotonic()
        for r in records:
            if r.meta is not None:
                r.meta["fetch_start"] = t0
                r.meta["fetch_end"] = t1
        return out

    def account(self, records: list, fetched: list) -> List[Tuple[int, dict]]:
        """Lagged bookkeeping over fetched results, in dispatch order.
        Mutates engine state (eviction, slot reuse): call under the lock. A
        record holds K frames, frame-major [K, B, ...]; frames emit in order
        per stream."""
        emitted = []
        if records:
            self.stats["fetch_calls"] += 1
            self.stats["records_fetched"] += len(records)
            self.stats["urgent_fetched"] += sum(r.urgent for r in records)
        for (codes, is_audio, fin, slow, pcm), rec in zip(fetched, records):
            self._unaccounted.discard(rec.seq)
            for k in range(rec.n_frames):
                for row, sid in rec.rows:
                    frame = {
                        "audio_codes": codes[k, row],
                        "is_audio": bool(is_audio[k, row]),
                        "finished": bool(fin[k, row]),
                        "slow_token": int(slow[k, row]),
                    }
                    if pcm is not None:
                        frame["pcm"] = pcm[k, row, :, 0]
                    frame = self._bookkeep(sid, frame)
                    if frame is not None:
                        emitted.append((sid, frame))
                        # admission records carry first frames: complete the
                        # stream's latency decomposition (see pop_timing)
                        t = rec.meta is not None and self.timings.get(sid)
                        if t and "first" not in t and "admit" in t:
                            t["fetch_start"] = rec.meta["fetch_start"]
                            t["fetch_end"] = rec.meta["fetch_end"]
                            t["first"] = time.monotonic()
        return emitted

    def take_due(self, kind: str = "all") -> list:
        """Pop the records whose fetch is due: `inflight` stay behind while
        work continues, `fetch_every` go at a time, all when idle. Urgent
        records (first frames) go at once, out of queue order.

        kind: "all", "urgent" (admission records only, for a dedicated
        low-latency fetcher) or "bulk" (everything else)."""
        urgent = []
        if kind in ("all", "urgent"):
            urgent = [r for r in self._queue if r.urgent]
            if urgent:
                self._queue = collections.deque(r for r in self._queue if not r.urgent)
            if kind == "urgent":
                return urgent
        bulk = [r for r in self._queue if not r.urgent]
        target = self.inflight if (self._pending or self._slot_to_stream) else 0
        due = len(bulk) - target
        if due <= 0 or (target > 0 and due < self.fetch_every):
            return urgent
        taken = set(id(r) for r in bulk[:due])
        self._queue = collections.deque(r for r in self._queue if id(r) not in taken)
        return urgent + bulk[:due]

    def _materialize(self, records: list) -> List[Tuple[int, dict]]:
        return self.account(records, self.fetch(records))

    def _release(self, sid: int):
        h = self._streams.pop(sid, None)
        if h is not None:
            self._free_slot(h)

    def step(self) -> List[Tuple[int, dict]]:
        """Admit pending streams, dispatch one frame (or chunk) for all live
        slots, and return the frames whose lagged fetch completed this call:
        [(stream_id, {audio_codes [ncb], is_audio, finished, slow_token,
        pcm?})]."""
        self.dispatch_step()
        emitted: List[Tuple[int, dict]] = []
        while True:
            records = self.take_due()
            if not records:
                break
            emitted.extend(self._materialize(records))
        return emitted

    @torch.no_grad()
    def dispatch_step(self, admit_only: bool = False) -> None:
        """Admit pending streams and dispatch one frame (or chunk) for all
        live slots; results queue for take_due / fetch / account.
        admit_only=True admits without advancing the live slots. Sharded,
        the plan goes to every rank first."""
        marks, self._to_mark = self._to_mark, []
        admits = self._plan_admissions()
        advance = None
        live_slots = list(self._slot_to_stream.items())
        if not admit_only and live_slots:
            K = self.chunk_frames if self.mimi_state is not None else 1
            flush = self._since_flush + K > self._flush_every
            if flush:
                self._since_flush = 0
            # The smallest bucket covering every live position (freed slots
            # keep advancing on the device, but their output is masked and
            # dropped).
            needed = int(max(self._slot_pos[slot] for slot, _ in live_slots)) + K
            lim = next(b for b in self.attend_buckets if b >= min(needed, self.S))
            self.last_attend_limit = lim
            advance = (K, lim, flush)
        plan = {"marks": marks, "admits": [a[:3] for a in admits], "advance": advance}
        if self.mesh is not None:
            self.mesh.broadcast_object(plan)
        snaps = self._execute(plan)
        t_admit = time.monotonic()
        for (payload, event), (_, _, _, sids) in zip(snaps, admits):
            for sid in sids:
                if sid in self.timings:
                    self.timings[sid]["admit"] = t_admit
            self._enqueue(Record(payload, list(enumerate(sids)), 1, urgent=True, meta={},
                                 event=event))
            self.stats["admissions"] += 1
        if advance is None:
            return
        K = advance[0]
        payload, event = snaps[-1]
        for slot, _ in live_slots:
            self._slot_pos[slot] += K
        self._since_flush += K
        self._enqueue(Record(payload, [(s, sid) for s, sid in live_slots], K, event=event))
        self.stats["dispatches"] += 1
        self.stats["frames_dispatched"] += K * len(live_slots)
        self.stats["frame_steps"] += K
        # Proactive slot reuse: the host knows a budget-limited stream's last
        # frame the moment it is dispatched.
        for _, sid in live_slots:
            h = self._streams.get(sid)
            if h is None:
                continue
            h.frames_dispatched += K
            if h.frames_dispatched >= h.max_frames:
                self._free_slot(h)

    def _execute(self, plan: dict) -> list:
        """The device work of one dispatch, on every rank alike: mark freed
        slots, admit, flush, advance. Returns the leader's snapshots (one per
        admission, then the step's), the step's outputs gathered over the
        data axis; a follower returns none."""
        snaps = []
        self._mark_freed(plan["marks"])
        for slots, prompt, lens in plan["admits"]:
            self.state, out, pcm0 = self._admit(self.state, self.mimi_state, slots, prompt, lens,
                                                self._admit_generator)
            if self.is_leader:
                snaps.append(self._snapshot((*_frame_major([out]),
                                             None if pcm0 is None else pcm0[None])))
        if plan["advance"] is not None:
            K, lim, flush = plan["advance"]
            if flush:
                self.state, self.mimi_state = self._flush(self.state, self.mimi_state)
            self.state, self.mimi_state, out, pcm = self._advance(
                self.state, self.mimi_state, K, lim, self.generator)
            outs = (*out, pcm)
            if self.mesh is not None:  # slots are axis 1 of the frame-major outputs
                outs = self.mesh.data_gather(outs, 1)
            if self.is_leader:
                snaps.append(self._snapshot(outs))
        return snaps

    @torch.no_grad()
    def follow(self) -> None:
        """A follower rank of a sharded engine: run the leader's plans until
        `release_followers`."""
        if self.mesh is None or self.is_leader:
            raise RuntimeError("DecodeEngine.follow: only a follower rank of a sharded "
                               "engine follows")
        while True:
            plan = self.mesh.broadcast_object(None)
            if plan is None:
                return
            if "warm" in plan:
                T, buckets = plan["warm"]
                self._warm(T, buckets, lambda s: None)
            else:
                self._execute(plan)

    def release_followers(self) -> None:
        """End the followers' `follow()` (a no-op unsharded)."""
        if self.mesh is not None and self.is_leader:
            self.mesh.broadcast_object(None)

    def has_work(self) -> bool:
        return bool(self._pending or self._slot_to_stream or self._queue)


class EngineLoop:
    """Background threads driving a DecodeEngine; frames fan out to
    per-stream queues.

    The DISPATCH thread admits prompts and dispatches steps (the only thread
    that launches device work); `fetchers` FETCH threads wait for records
    outside the engine lock. Urgent records (first frames) are ACCOUNTED the
    moment they land; every other record once all records dispatched before
    it (`Record.seq`), urgent ones included, have been, so each stream's
    frames reach its queue in dispatch order. With two or more fetchers one
    is dedicated to urgent records.

    `max_ahead` bounds the un-fetched records dispatch may run ahead; it is
    also the first-audio latency knob (a new stream's prefill runs behind at
    most `max_ahead` queued records).

    The engine lock is a `TimedLock` over `engine.stats`: the dispatcher
    takes it as "dispatch", fetchers (taking records, accounting them) as
    "fetch", `submit` as "submit", anything else as "other"."""

    def __init__(self, engine: DecodeEngine, poll_interval: float = 0.002,
                 max_ahead: Optional[int] = None, fetchers: int = 2):
        self.engine = engine
        self.poll_interval = poll_interval
        self._queues: Dict[int, "queue.Queue"] = {}
        self._lock = TimedLock(engine.stats)
        self._stop = threading.Event()
        self._acct_cv = threading.Condition(self._lock.role("fetch"))
        self._max_ahead = (max_ahead if max_ahead is not None
                           else engine.inflight + max(2, engine.fetch_every))
        # The drain invariant: below inflight + fetch_every the dispatch gate
        # caps the queue under the bulk fetchers' threshold and nothing ever
        # drains. A shallow max_ahead is a latency preference, so the
        # engine's fetch batching (and, if needed, its inflight depth)
        # shrinks to fit.
        if self._max_ahead < engine.inflight + engine.fetch_every:
            engine.fetch_every = max(1, self._max_ahead - engine.inflight)
            if self._max_ahead < engine.inflight + engine.fetch_every:
                engine.inflight = max(0, self._max_ahead - engine.fetch_every)
        assert self._max_ahead >= engine.inflight + engine.fetch_every
        self._dispatcher = threading.Thread(target=self._dispatch_loop, daemon=True)
        n = max(1, int(fetchers))
        kinds = (["urgent"] + ["bulk"] * (n - 1)) if n >= 2 else ["all"]
        self._fetchers = [threading.Thread(target=self._fetch_loop, args=(kind,), daemon=True)
                          for kind in kinds]
        self._dispatcher.start()
        for t in self._fetchers:
            t.start()

    def submit(self, prompt: np.ndarray, max_frames: Optional[int] = None) -> "queue.Queue":
        lock = self._lock.role("submit")
        with SPANS.span("engine.submit_wait"):
            lock.acquire()
        try:
            sid = self.engine.submit(prompt, max_frames)
            q: "queue.Queue" = queue.Queue()
            self._queues[sid] = q
        finally:
            lock.release()
        q.sid = sid  # for engine.pop_timing(sid)
        return q

    def _dispatch_loop(self):
        lock, stats = self._lock.role("dispatch"), self.engine.stats
        gate_wait = 0.0  # asleep at the shut gate since the lock was last held
        while not self._stop.is_set():
            with lock:
                stats["gate_wait_s"] += gate_wait
                eng = self.engine
                live = bool(eng._pending or eng._slot_to_stream)
                gate_open = len(eng._queue) < self._max_ahead
                admit_past_gate = bool(not gate_open and eng._pending and eng._free)
                work = (live and gate_open) or admit_past_gate
                if work:
                    # Admissions pass the max_ahead gate (admit_only: no bulk
                    # frame), adding one small urgent record.
                    t0 = time.perf_counter()
                    eng.dispatch_step(admit_only=admit_past_gate)
                    stats["dispatch_s"] += time.perf_counter() - t0
            gate_wait = 0.0
            if not work:
                t0 = time.perf_counter()
                time.sleep(self.poll_interval)
                if live:  # the gate is shut: waiting on fetch
                    gate_wait = time.perf_counter() - t0

    def _emit(self, frames) -> None:
        for sid, frame in frames:
            q = self._queues.get(sid)
            if q is not None:
                q.put(frame)
                if frame["finished"]:
                    q.put(None)  # sentinel
                    self._queues.pop(sid, None)

    def _account_in_order(self, records, fetched) -> None:
        """Urgent records at once; any other record after every record
        dispatched before it, across all fetcher threads. Its frames go on
        their queues under the same lock (an unbounded put never blocks), so
        two fetchers cannot interleave one stream's frames."""
        pending = self.engine._unaccounted
        for rec, data in zip(records, fetched):
            with self._acct_cv:
                while (not rec.urgent and min(pending) < rec.seq
                       and not self._stop.is_set()):
                    self._acct_cv.wait(0.05)
                self._emit(self.engine.account([rec], [data]))
                self._acct_cv.notify_all()

    def _fetch_loop(self, kind: str = "all"):
        lock = self._lock.role("fetch")
        while not self._stop.is_set():
            with lock:
                records = self.engine.take_due(kind)
            if not records:
                time.sleep(self.poll_interval)
                continue
            fetched = self.engine.fetch(records)  # lock NOT held
            self._account_in_order(records, fetched)

    def stop(self):
        self._stop.set()
        with self._lock:
            self._acct_cv.notify_all()
        self._dispatcher.join(timeout=5)
        for t in self._fetchers:
            t.join(timeout=5)
        # Streams still open end here, so a consumer blocked on q.get wakes.
        with self._lock:
            for q in self._queues.values():
                q.put(None)
            self._queues.clear()
