"""Inverse rendering on the port: the megakernel-forward gradient (mega.py),
the Adam fit (inverse.py) and its checkpoints (checkpoint.py)."""
