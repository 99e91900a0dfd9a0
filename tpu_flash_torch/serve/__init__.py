"""HTTP serving front end for the port's continuous-batching engine."""

from tpu_flash_torch.serve.server import ByteTokenizer, EngineServer, serve

__all__ = ["ByteTokenizer", "EngineServer", "serve"]
