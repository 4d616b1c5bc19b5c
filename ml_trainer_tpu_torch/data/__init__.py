"""Host-side input pipeline: datasets, batch transforms, the sharded
sampler, the numpy ``Loader``, the C++ ``NativeLoader`` (``native``), the
memory-mapped shard datasets (``sharded``), the tokenizers and text
datasets (``tokenizers``, ``text``) and a pinned-memory device prefetch."""

from ml_trainer_tpu_torch.data.datasets import (
    CIFAR10,
    ArrayDataset,
    Dataset,
    SyntheticCIFAR10,
    SyntheticTokens,
    as_dataset,
)
from ml_trainer_tpu_torch.data.loader import Loader, prefetch_to_device
from ml_trainer_tpu_torch.data.native import (
    NativeLoader,
    native_available,
    native_plan,
)
from ml_trainer_tpu_torch.data.sampler import ShardedSampler
from ml_trainer_tpu_torch.data.sharded import (
    ShardedImageDataset,
    ShardedJpegDataset,
    ingest_image_folder,
    write_sharded_dataset,
    write_sharded_jpeg_dataset,
)
from ml_trainer_tpu_torch.data.text import (
    PackedLMDataset,
    TokenizedDataset,
    load_sst2_tsv,
    pack_texts,
    tokenize_texts,
)
from ml_trainer_tpu_torch.data.tokenizers import (
    ByteLevelBPETokenizer,
    WordPieceTokenizer,
    load_tokenizer,
)
from ml_trainer_tpu_torch.data.transforms import (
    Compose,
    ForeignTransform,
    Normalize,
    RandomCrop,
    RandomHorizontalFlip,
    ToFloat,
    Transform,
)

__all__ = [
    "CIFAR10", "ArrayDataset", "ByteLevelBPETokenizer", "Compose",
    "Dataset", "ForeignTransform", "Loader", "NativeLoader", "Normalize",
    "PackedLMDataset", "RandomCrop", "RandomHorizontalFlip",
    "ShardedImageDataset", "ShardedJpegDataset", "ShardedSampler",
    "SyntheticCIFAR10", "SyntheticTokens", "ToFloat", "TokenizedDataset",
    "Transform", "WordPieceTokenizer", "as_dataset", "ingest_image_folder",
    "load_sst2_tsv", "load_tokenizer", "native_available", "native_plan",
    "pack_texts", "prefetch_to_device", "tokenize_texts",
    "write_sharded_dataset", "write_sharded_jpeg_dataset",
]
