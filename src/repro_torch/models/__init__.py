from repro_torch.models import embedding, layers, transformer

__all__ = ["embedding", "layers", "transformer"]
