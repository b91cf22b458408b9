"""The multi-process launcher (``python -m
parallelwavegan_torch.distributed.launch``)."""
