"""Dataset preview: listen to random Mimi-decoded rows.

As the JAX package's `data_pipeline/preview.py`: gradio when it imports;
otherwise the port's own HTTP server, where `/random` returns a random row
decoded to WAV and `/` a page that plays it.

    python -m smoltts_torch.data_pipeline.preview --dataset-path dir \\
        --mimi-path mimi.safetensors [--port 7860] [--device cpu]
"""

from __future__ import annotations

import argparse
import random

import numpy as np


def clamp_codes(codes: np.ndarray, codebook_size: int) -> np.ndarray:
    """Ids as the JAX decoder's gather reads them: a negative id counts from
    the end of the codebook, and every id is clamped into it. A
    `ground_truth` row (text ids and semantic ids up to the vocab's end in
    row 0) thus decodes to the JAX package's PCM."""
    codes = np.asarray(codes, np.int64)
    codes = np.where(codes < 0, codes + codebook_size, codes)
    return np.clip(codes, 0, codebook_size - 1)


def _decode_row(codec, row) -> bytes:
    from smoltts_torch.io.wav import pcm_to_wav_bytes

    codes = row["ground_truth" if "ground_truth" in row else "codes"]
    pcm = codec.decode(clamp_codes(codes, codec.config.codebook_size))
    return pcm_to_wav_bytes(pcm, codec.config.sampling_rate)


def preview_app(dataset, codec):
    """The stdlib preview server: `/random` and `/`."""
    from smoltts_torch.server.http import HttpServer, Response

    app = HttpServer()

    @app.get("/random")
    async def random_row(req):
        row = dataset[random.randrange(len(dataset))]
        return Response(_decode_row(codec, row), content_type="audio/wav")

    @app.get("/")
    async def index(req):
        return Response(
            "<html><body><h1>dataset preview</h1>"
            '<audio controls src="/random"></audio>'
            "<p>Reload for a new random row.</p></body></html>",
            content_type="text/html",
        )

    return app


def serve_preview(dataset, codec, host: str = "0.0.0.0", port: int = 7860):
    try:
        import gradio as gr  # type: ignore

        def sample():
            row = dataset[random.randrange(len(dataset))]
            pcm = codec.decode(np.asarray(row["codes"]))
            return (codec.config.sampling_rate, pcm), str(
                {k: v for k, v in row.items() if k != "codes"}
            )

        demo = gr.Interface(fn=sample, inputs=[], outputs=[gr.Audio(), gr.Text()])
        demo.launch(server_name=host, server_port=port)
        return
    except ImportError:
        pass

    print(f"preview on http://{host}:{port} (gradio unavailable; stdlib server)")
    preview_app(dataset, codec).run(host, port)


def main(argv=None):
    parser = argparse.ArgumentParser(description="Preview a Mimi-encoded dataset")
    parser.add_argument("--dataset-path", required=True)
    parser.add_argument("--mimi-path", required=True)
    parser.add_argument("--port", type=int, default=7860)
    parser.add_argument("--device", type=str, default=None, help="default: cuda")
    args = parser.parse_args(argv)

    from smoltts_torch import resolve_device
    from smoltts_torch.codec.mimi import load_mimi
    from smoltts_torch.data_pipeline.encode_audio import MimiCodec

    dev = resolve_device(args.device)
    from datasets import load_from_disk

    params, cfg = load_mimi(args.mimi_path, device=dev)
    codec = MimiCodec(params, cfg, device=dev)
    dataset = load_from_disk(args.dataset_path)
    serve_preview(dataset, codec, port=args.port)


if __name__ == "__main__":
    main()
