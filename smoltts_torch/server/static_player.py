"""Static web player: fetches the PCM streaming endpoint and plays 80 ms
chunks through WebAudio at 24 kHz (reference: mlx_inference/static/index.html)."""

INDEX_HTML = """<!DOCTYPE html>
<html>
<head>
  <meta charset="utf-8">
  <title>smoltts-tpu streaming player</title>
  <style>
    body { font-family: system-ui, sans-serif; max-width: 640px; margin: 3rem auto; }
    textarea { width: 100%; height: 6rem; }
    button { padding: 0.5rem 1.5rem; margin-top: 0.5rem; }
    #status { color: #666; margin-top: 0.5rem; }
  </style>
</head>
<body>
  <h1>smoltts-tpu</h1>
  <textarea id="text">Hello! This audio is being streamed to you in 80 millisecond chunks.</textarea>
  <div>
    <label>Voice id <input id="voice" value="0" size="4"></label>
    <button id="speak">Speak</button>
  </div>
  <div id="status"></div>
  <script>
    const SAMPLE_RATE = 24000;
    document.getElementById('speak').onclick = async () => {
      const status = document.getElementById('status');
      const text = document.getElementById('text').value;
      const voice = document.getElementById('voice').value || '0';
      const ctx = new AudioContext({ sampleRate: SAMPLE_RATE });
      let playhead = ctx.currentTime + 0.1;
      status.textContent = 'requesting…';
      const resp = await fetch(`/v1/text-to-speech/${voice}/stream`, {
        method: 'POST',
        headers: { 'Content-Type': 'application/json' },
        body: JSON.stringify({ text }),
      });
      if (!resp.ok) { status.textContent = 'error ' + resp.status; return; }
      const reader = resp.body.getReader();
      let leftover = new Uint8Array(0);
      let chunks = 0;
      while (true) {
        const { done, value } = await reader.read();
        if (done) break;
        const data = new Uint8Array(leftover.length + value.length);
        data.set(leftover); data.set(value, leftover.length);
        const usable = data.length - (data.length % 2);
        leftover = data.slice(usable);
        const pcm16 = new Int16Array(data.buffer.slice(0, usable));
        if (!pcm16.length) continue;
        const f32 = Float32Array.from(pcm16, s => s / 32768);
        const buf = ctx.createBuffer(1, f32.length, SAMPLE_RATE);
        buf.copyToChannel(f32, 0);
        const src = ctx.createBufferSource();
        src.buffer = buf; src.connect(ctx.destination);
        playhead = Math.max(playhead, ctx.currentTime);
        src.start(playhead);
        playhead += buf.duration;
        status.textContent = `playing… ${++chunks} chunks`;
      }
      status.textContent += ' (done)';
    };
  </script>
</body>
</html>
"""
