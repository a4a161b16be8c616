"""Inverse rendering on the port: the megakernel-forward gradient (mega.py),
the Adam fits of the scene and the camera (inverse.py), their checkpoints
(checkpoint.py) and the finite-difference check (fd.py)."""
