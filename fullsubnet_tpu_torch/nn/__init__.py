"""Sequence blocks: the plain stacked LSTM and ``SequenceModel``."""
