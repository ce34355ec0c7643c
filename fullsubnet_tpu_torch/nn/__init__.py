"""Sequence blocks: the plain stacked LSTM and GRU and ``SequenceModel``."""
