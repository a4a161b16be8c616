"""Runnable examples of the port:
python -m rays1bench_tpu_torch.examples.<name>."""
