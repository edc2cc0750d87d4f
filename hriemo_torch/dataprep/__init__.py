"""IEMOCAP data preparation of the port: corpus index, batched WavLM/BERT
feature extraction on the card, and feature-store integrity checks (ports
of ``hriemo/dataprep``; no pandas)."""
