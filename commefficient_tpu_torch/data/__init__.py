from commefficient_tpu_torch.data.batching import FedBatcher, val_batches
from commefficient_tpu_torch.data.fed_dataset import (FedDataset,
                                                     PreparedArrayDataset)
from commefficient_tpu_torch.data.offline import FedDigits, FedPatches32
from commefficient_tpu_torch.data.persona import FedPERSONA, SyntheticPersona
from commefficient_tpu_torch.data.sampler import FedSampler
from commefficient_tpu_torch.data.synthetic import SyntheticCV

#: ported datasets; the file-backed ones are ROADMAP.md A7b
fed_datasets = {"Synthetic": SyntheticCV, "Digits": FedDigits,
                "Patches32": FedPatches32}

__all__ = ["FedDataset", "PreparedArrayDataset", "SyntheticCV", "FedDigits",
           "FedPatches32", "FedPERSONA", "SyntheticPersona",
           "FedSampler", "FedBatcher", "val_batches", "fed_datasets"]
