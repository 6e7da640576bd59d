from repro_torch.serve.engine import EngineStats, Request, ServeEngine

__all__ = ["EngineStats", "Request", "ServeEngine"]
