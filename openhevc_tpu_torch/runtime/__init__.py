"""Host runtime: pipelined decode (frame-threading equivalent)."""

from .pipeline import PipelinedDecoder

__all__ = ["PipelinedDecoder"]
