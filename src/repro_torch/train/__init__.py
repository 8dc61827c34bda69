"""Training-side utilities of the port (counterpart of ``repro.train``):
for now the numpy-backed checkpoint layout (``train.checkpoint``)."""
