from commefficient_tpu_torch.data.batching import FedBatcher, val_batches
from commefficient_tpu_torch.data.cifar import FedCIFAR10, FedCIFAR100
from commefficient_tpu_torch.data.emnist import FedEMNIST
from commefficient_tpu_torch.data.fed_dataset import (FedDataset,
                                                     PreparedArrayDataset)
from commefficient_tpu_torch.data.imagenet import FedImageNet
from commefficient_tpu_torch.data.offline import FedDigits, FedPatches32
from commefficient_tpu_torch.data.persona import FedPERSONA, SyntheticPersona
from commefficient_tpu_torch.data.sampler import FedSampler
from commefficient_tpu_torch.data.synthetic import SyntheticCV

#: the CV datasets, by ``--dataset_name``
fed_datasets = {
    "CIFAR10": FedCIFAR10,
    "CIFAR100": FedCIFAR100,
    "EMNIST": FedEMNIST,
    "ImageNet": FedImageNet,
    "Synthetic": SyntheticCV,
    "Digits": FedDigits,
    "Patches32": FedPatches32,
}

__all__ = ["FedDataset", "PreparedArrayDataset", "FedCIFAR10", "FedCIFAR100",
           "FedEMNIST", "FedImageNet", "SyntheticCV", "FedDigits",
           "FedPatches32", "FedPERSONA", "SyntheticPersona", "FedSampler",
           "FedBatcher", "val_batches", "fed_datasets"]
