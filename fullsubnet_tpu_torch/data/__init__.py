"""Data: wav I/O, the training and inference datasets, the training loader,
and the device-side mixer of device synthesis."""
