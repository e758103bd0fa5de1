"""Host ms the library spends per streamed chunk bringing its PCM to the
host, where it waits for the card: the mean of `SmolTTS.stream`'s
`stream.to_host` spans (one per chunk, one frame at B=1) inside the quiet
stretches."""

from portbench.program_spans import mean_ms


def read(ctx):
    return mean_ms(ctx, "stream.to_host")
