"""Data preparation of the port (ports of ``hriemo/dataprep``; no pandas):
the IEMOCAP corpus index, batched WavLM/BERT feature extraction on the
card and feature-store integrity checks; the MOSEI index, standard folds
and ``.csd`` slicing (host only; ``h5py`` is imported where a ``.csd``
file is read)."""
