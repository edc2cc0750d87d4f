"""The port's data layer: the feature store, the index datasets, batching
and synthetic corpora (copies of ``hriemo/data``, which the port does not
import)."""

from .batching import BucketBatcher, pad_batch, prefetch_to_device, stack_utter_batch
from .datasets import (SeqLevelDataset, UtterLevelDataset, build_label2id, crop_center,
                       read_index_csv)
from .feature_store import load_feature, load_utter_feature, read_meta, save_feature, write_meta

__all__ = ["load_feature", "load_utter_feature", "save_feature", "read_meta", "write_meta",
           "SeqLevelDataset", "UtterLevelDataset", "build_label2id", "crop_center",
           "read_index_csv", "BucketBatcher", "pad_batch", "prefetch_to_device",
           "stack_utter_batch"]
