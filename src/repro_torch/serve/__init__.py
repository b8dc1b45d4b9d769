from .engine import GenerationResult, ServeEngine
