from commefficient_tpu_torch.data.batching import FedBatcher, val_batches
from commefficient_tpu_torch.data.fed_dataset import FedDataset
from commefficient_tpu_torch.data.sampler import FedSampler
from commefficient_tpu_torch.data.synthetic import SyntheticCV

#: ported datasets; the file-backed ones are ROADMAP.md A7
fed_datasets = {"Synthetic": SyntheticCV}

__all__ = ["FedDataset", "SyntheticCV", "FedSampler", "FedBatcher",
           "val_batches", "fed_datasets"]
