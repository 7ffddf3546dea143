from repro_torch.data.pipeline import SyntheticLMData, to_device

__all__ = ["SyntheticLMData", "to_device"]
