"""Feature store of the port (copy of ``hriemo/data/feature_store.py``)."""

from .feature_store import load_feature, load_utter_feature, read_meta, save_feature, write_meta

__all__ = ["load_feature", "load_utter_feature", "save_feature", "read_meta", "write_meta"]
