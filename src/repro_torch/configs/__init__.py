from repro_torch.configs.graphic_gcn import CONFIG, PALLAS_CONFIG

__all__ = ["CONFIG", "PALLAS_CONFIG"]
