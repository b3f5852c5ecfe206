from repro_torch.data.pipeline import SyntheticTextDataset, for_arch

__all__ = ["SyntheticTextDataset", "for_arch"]
