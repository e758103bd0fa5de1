"""smoltts-server on the port: the HTTP API over SmolTTS and its engine.

The routes of the JAX package's `smoltts_tpu/server/app.py` (the reference
server's OpenAI and ElevenLabs schemas):

  POST /v1/audio/speech                       OpenAI-compatible, WAV attachment
  POST /v1/text-to-speech/{voice_id}          ElevenLabs-compatible blocking
  POST /v1/text-to-speech/{voice_id}/stream   raw PCM16 streaming (X-Sample-Rate)
  GET  /                                      static WebAudio PCM player
  GET  /health                                liveness + model info
  GET  /metrics                               serving counters

    python -m smoltts_torch.server.app --config cfg.json --engine-slots 64

serves on the card; a core built on the CPU (`SmolTTS(..., device="cpu")`,
as the tests build it) serves through the plain path.
"""

from __future__ import annotations

import argparse
import asyncio
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

from smoltts_torch.io.wav import pcm_to_int16
from smoltts_torch.server.http import HttpServer, Request, Response, StreamingResponse
from smoltts_torch.server.settings import ServerSettings
from smoltts_torch.server.static_player import INDEX_HTML
from smoltts_torch.server.tts_core import TTSCore
from smoltts_torch.utils.profiling import ServingMetrics


def build_app(core: TTSCore, engine_loop=None, metrics=None) -> HttpServer:
    """`engine_loop` (smoltts_torch.lm.engine.EngineLoop with a vocoder)
    enables continuous-batched streaming: concurrent /stream requests share
    the card through decode slots instead of serializing."""
    metrics = metrics or ServingMetrics()
    app = HttpServer()
    # Each live engine stream parks ONE blocking q.get in an executor while
    # awaiting its next frame; asyncio's default pool has min(32, cpus + 4)
    # threads, so beyond that many concurrent streams the rest would starve
    # with their frames ready. The pool is sized to the engine's slots.
    stream_executor = None
    if engine_loop is not None:
        stream_executor = ThreadPoolExecutor(
            max_workers=engine_loop.engine.num_slots + 8,
            thread_name_prefix="stream-q",
        )
        app.on_stop.append(lambda: stream_executor.shutdown(wait=False, cancel_futures=True))

    @app.get("/")
    async def index(req: Request):
        return Response(INDEX_HTML, content_type="text/html; charset=utf-8")

    @app.get("/health")
    async def health(req: Request):
        return Response.json({"status": "ok", "sampling_rate": core.model.sampling_rate})

    @app.get("/metrics")
    async def metrics_route(req: Request):
        snap = metrics.snapshot()
        if engine_loop is not None:
            # the engine's counters, lock waits and holds by role included
            # (a copy without the engine lock, which a dispatch holds long)
            snap["engine"] = dict(engine_loop.engine.stats)
        return Response.json(snap)

    @app.post("/v1/audio/speech")
    async def openai_speech(req: Request):
        item = req.json()
        if "input" not in item:
            return Response.error(422, "missing required field: input")
        response_format = item.get("response_format", "wav")
        if response_format != "wav":
            return Response.error(422, "response_format must be 'wav'")
        audio, media_type = await asyncio.to_thread(
            core.generate_audio,
            item["input"],
            item.get("voice", "alloy"),
            response_format + "_24000",
        )
        return Response(
            audio,
            content_type=media_type,
            headers={"Content-Disposition": 'attachment; filename="speech.wav"'},
        )

    @app.post("/v1/text-to-speech/{voice_id}")
    async def elevenlabs_speech(req: Request):
        item = req.json()
        if "text" not in item:
            return Response.error(422, "missing required field: text")
        output_format = req.query_param("output_format") or "pcm_24000"
        try:
            audio, media_type = await asyncio.to_thread(
                core.generate_audio, item["text"], req.path_params["voice_id"], output_format
            )
        except NotImplementedError as e:
            return Response.error(501, str(e))
        return Response(
            audio,
            content_type=media_type,
            headers={
                "Content-Disposition": f'attachment; filename="elevenlabs_speech.{output_format.split("_")[0]}"',
                "X-Sample-Rate": output_format.split("_")[1],
            },
        )

    @app.post("/v1/text-to-speech/{voice_id}/stream")
    async def elevenlabs_stream(req: Request):
        item = req.json()
        if "text" not in item:
            return Response.error(422, "missing required field: text")
        voice = req.path_params["voice_id"]
        metrics.record_request()
        t_submit = time.monotonic()

        if engine_loop is not None:
            prompt = core.model._get_prompt(item["text"], voice)
            # submit takes the engine lock, which the dispatch thread holds
            # through each host-bound dispatch (~0.4 s a chunk at 64 slots on
            # an H100 80GB HBM3 at 700 W, PERF.md): on the event loop it would
            # stall every other stream's writes for that long.
            q = await asyncio.get_running_loop().run_in_executor(
                stream_executor, engine_loop.submit, prompt)

            async def chunks():
                loop = asyncio.get_running_loop()
                first = True
                while True:
                    frame = await loop.run_in_executor(stream_executor, q.get)
                    if frame is None:
                        break
                    if first:
                        metrics.record_first_audio(time.monotonic() - t_submit)
                        first = False
                    metrics.record_frames(1)
                    if "pcm" in frame:
                        yield pcm_to_int16(frame["pcm"]).tobytes()

        else:

            async def chunks():
                loop = asyncio.get_running_loop()
                gen = core.stream_audio(item["text"], voice)
                first = True
                while True:
                    chunk = await loop.run_in_executor(None, next, gen, None)
                    if chunk is None:
                        break
                    if first:
                        metrics.record_first_audio(time.monotonic() - t_submit)
                        first = False
                    metrics.record_frames(1)
                    yield chunk

        return StreamingResponse(
            chunks(),
            content_type="audio/x-pcm",
            headers={
                "Content-Disposition": 'attachment; filename="speech.pcm"',
                "X-Sample-Rate": "24000",
            },
        )

    return app


def load_core(settings: ServerSettings) -> TTSCore:
    """SmolTTS on the card from the settings' checkpoint (no quantization,
    as the JAX server). Raises on a host without a card before any file is
    read or downloaded."""
    from smoltts_torch import SmolTTS, resolve_device

    resolve_device(None)
    t0 = time.time()
    model = SmolTTS(
        settings.get_checkpoint_dir(),
        mimi_path=settings.mimi_path,
        generation_settings=settings.generation.to_settings(),
    )
    print(f"Loaded model and config in {time.time() - t0:.2f}s")
    return TTSCore(model, settings)


def build_engine_loop(
    core: TTSCore,
    num_slots: int = 32,
    inflight: int = 1,
    fetch_every: int = 1,
    chunk_frames: int = 4,
):
    """Continuous-batched decode engine + vocoder over the loaded model, on the
    model's device. `chunk_frames` enables chunked dispatch (K frames per
    dispatch while no admissions wait): per-frame dispatch work drops K-fold
    at the cost of up to inflight*K*80 ms extra admission latency under load."""
    from smoltts_torch.lm.engine import DecodeEngine, EngineLoop

    m = core.model
    engine = DecodeEngine(
        m.params,
        m.config,
        m.token_config,
        m.generation_settings,
        num_slots=num_slots,
        mimi_params=m.codec_params,
        mimi_cfg=m.codec_config,
        inflight=inflight,
        fetch_every=fetch_every,
        emit_format="int16",  # the stream route serves PCM16; half the bytes of f32
        chunk_frames=chunk_frames,
        device=m.device,
    )
    engine.warm()  # every kernel and cuDNN choice made before a live request
    # max_ahead=2 / fetchers=3: a shallow dispatch queue bounds admission
    # latency; one fetcher is dedicated to first frames, two overlap the rest.
    return EngineLoop(engine, max_ahead=2, fetchers=3)


def main(argv: Optional[list] = None):
    parser = argparse.ArgumentParser(description="smoltts TTS server on the card")
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument("--host", type=str, default="0.0.0.0")
    parser.add_argument("--config", type=str, default=None)
    parser.add_argument(
        "--engine-slots",
        type=int,
        default=0,
        help="enable continuous batching with N decode slots (0 = per-request)",
    )
    args = parser.parse_args(argv)

    settings = ServerSettings.get_settings(args.config)
    core = load_core(settings)
    engine_loop = (
        build_engine_loop(core, args.engine_slots) if args.engine_slots > 0 else None
    )
    app = build_app(core, engine_loop=engine_loop)
    print(f"Serving on http://{args.host}:{args.port}")
    try:
        app.run(args.host, args.port)
    finally:
        if engine_loop is not None:
            engine_loop.stop()


if __name__ == "__main__":
    main()
