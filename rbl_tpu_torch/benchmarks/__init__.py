"""Benchmarks of the port that run on the card (``python -m
rbl_tpu_torch.benchmarks.<name>``): counterparts of the JAX package's
scripts under ``benchmarks/``, with the same names, flags and output."""
