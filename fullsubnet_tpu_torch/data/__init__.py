"""Host-side data: wav I/O, the training and inference datasets, and the
training loader."""
