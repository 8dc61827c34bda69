from repro_torch.roofline import analysis

__all__ = ["analysis"]
