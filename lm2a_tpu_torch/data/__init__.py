"""Data: npz clips, packed splits and their batch gatherers, the raw-tree
preprocessor and the split (the JAX package's ``lm2a_tpu.data`` exports)."""

from lm2a_tpu_torch.data.dataset import (
    BatchIterator,
    MelNpzDataset,
    PackedDataset,
    compute_dataset_stats,
    device_prefetch,
    list_npz,
    pack_dataset,
)
from lm2a_tpu_torch.data.schema import (
    ALL_KEYS,
    REQUIRED_KEYS,
    Sample,
    load_sample,
    normalize_mel_layout,
    save_sample,
)
from lm2a_tpu_torch.data.split import SplitResult, split_dataset

__all__ = [
    "BatchIterator",
    "MelNpzDataset",
    "PackedDataset",
    "compute_dataset_stats",
    "device_prefetch",
    "list_npz",
    "pack_dataset",
    "ALL_KEYS",
    "REQUIRED_KEYS",
    "Sample",
    "load_sample",
    "normalize_mel_layout",
    "save_sample",
    "SplitResult",
    "split_dataset",
]
