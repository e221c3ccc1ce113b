"""Host I/O: tokenizers, weight import, data pipelines."""

from .data import (IMAGENET_MEANS, IMAGENET_STDS, DataLoader,
                   ImageFolderDataset, SyntheticImageDataset,
                   SyntheticVideoDataset, denormalize)
from .shapes_dataset import CaptionedShapesDataset, ShapesDataset
from .spm_tokenizer import (SD3Tokenizer, SentencePieceUnigram,
                            T5XXLTokenizer)
from .tokenizer import CLIPTokenizer
