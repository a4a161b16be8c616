"""A kernel's share of its roofline, from the traced window: the least time
the card could take for the work the frozen count gives (the larger of
bytes over the HBM peak and operations over the float32 peak, per launch),
over the kernel's device time, in percent."""

from __future__ import annotations

import json
import pathlib

from port_bench import trace as tr


def peaks(root: pathlib.Path) -> dict:
    with open(root / "peaks.json") as f:
        return json.load(f)


def share(result: dict, function: str, work: tuple, root) -> float:
    """work: (bytes, operations) of one launch. None where the traced
    window holds no launch of `function`."""
    t = result.get("trace")
    if not t:
        return None
    seconds, launches = tr.kernel_time(t, function)
    if not launches or seconds <= 0:
        return None
    p = peaks(root)
    bound = max(work[0] / p["hbm_bytes_per_s"], work[1] / p["fp32_ops_per_s"])
    return 100.0 * launches * bound / seconds


# The program's kernels, by the names of their __global__ functions.
PORT_KERNELS = ("respawn_kernel", "oneshot_kernel", "backward_kernel",
                "phase_kernel", "index_kernel")


def torch_ops_s(result: dict) -> float:
    """Device busy seconds of the traced window, the collectives left out,
    less the program's kernels' seconds; None without a trace."""
    t = result.get("trace")
    if not t:
        return None
    return t["compute_s"] - sum(tr.kernel_time(t, k)[0] for k in PORT_KERNELS)
