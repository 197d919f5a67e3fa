from repro_torch.analysis.markers import tag

__all__ = ["tag"]
