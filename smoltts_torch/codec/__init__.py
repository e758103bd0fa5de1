"""Mimi codec, streaming decode side."""
