"""Host-side data: wav I/O and the inference dataset."""
