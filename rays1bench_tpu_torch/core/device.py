"""Where the port's entry points put their tensors.

Every entry point that makes tensors (the scene builders, SphereSOABuilder.
finalize, CameraSpec.build, scene/convert.py, grad.inverse.fit_scene) takes
`device="cuda"` by default: the port runs on the card unless the caller asks
for the CPU. With no card, the default raises instead of quietly running the
plain version on the host.
"""

from __future__ import annotations

import dataclasses

import torch


def resolve(device) -> torch.device:
    """torch.device(device), refusing a CUDA device that torch cannot see."""
    d = torch.device(device)
    if d.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} asked for, but torch sees no CUDA "
            f"device; pass device='cpu' to run the plain version on the CPU")
    return d


def to_device(obj, device):
    """A copy of a dataclass of tensors (SphereSOA, Camera) on `device`."""
    return dataclasses.replace(obj, **{
        f.name: getattr(obj, f.name).to(device)
        for f in dataclasses.fields(obj)})
