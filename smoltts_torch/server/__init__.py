"""The port's HTTP server: the OpenAI and ElevenLabs routes over SmolTTS and its engine."""
