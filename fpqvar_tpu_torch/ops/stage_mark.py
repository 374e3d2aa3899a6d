"""The stage marker (``csrc/stage_mark.cu``): an empty kernel that the
engine launches at the start of each scale of a generation and once after
the last (``VARGenerator._steps``).

Captured into a generation's CUDA graph, the markers split each replay's
kernels by scale in a device trace: the kernels from one marker to the
next, in the order they ran, are one scale's.  The kernel's name is
:data:`STAGE_MARK_KERNEL`.  On the CPU a marker does nothing.
"""
from __future__ import annotations

import ctypes

import torch

from fpqvar_tpu_torch.ops import _build

#: the marker kernel's name, as a device trace shows it
STAGE_MARK_KERNEL = "fpq_stage_mark"


def stage_mark(stage: int, device) -> None:
    """Launch the marker of ``stage`` on the current stream of ``device``;
    nothing on the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return
    lib = _build.load("stage_mark", [ctypes.c_int])
    _build.launch(lib, "stage_mark", device, int(stage))
