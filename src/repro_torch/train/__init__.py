"""Training-side utilities of the port (counterpart of ``repro.train``):
the trainer (``train.trainer``) and the numpy-backed, async
checkpoints (``train.checkpoint``)."""
