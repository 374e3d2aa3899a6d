"""Float32 that stays float32 on a card, and the VQVAE's convolutions.

PyTorch runs cuDNN convolutions in TF32 by default
(``torch.backends.cudnn.allow_tf32`` is True in a fresh process), which
rounds their operands to 10 mantissa bits, and a process may turn TF32 on
for cuBLAS matmuls too; JAX's CPU reference and the port's CPU path
compute them in float32.  The code that must match them pins float32
itself (:func:`ieee_f32`) instead of relying on the process's flags.
"""
from __future__ import annotations

import contextlib
import threading

import torch
import torch.nn.functional as F

_PIN_LOCK = threading.Lock()
_pin_holders = 0
_pin_saved = (False, False)


@contextlib.contextmanager
def ieee_f32():
    """cuBLAS matmuls and cuDNN convolutions in float32 inside the block,
    whatever ``allow_tf32`` says.

    The two flags are process-wide, so the blocks of every thread share
    one pin: the first block to enter saves the flags and turns TF32 off,
    the last to leave puts them back (a server's worker thread and its
    caller can both be inside).  Meanwhile a float32 matmul or convolution
    that another thread runs outside any block also runs in float32: more
    exact, never less.  A flag set while a block is open is overwritten
    when the last block closes."""
    global _pin_holders, _pin_saved
    with _PIN_LOCK:
        if _pin_holders == 0:
            _pin_saved = (torch.backends.cuda.matmul.allow_tf32,
                          torch.backends.cudnn.allow_tf32)
            if any(_pin_saved):
                torch.backends.cuda.matmul.allow_tf32 = False
                torch.backends.cudnn.allow_tf32 = False
        _pin_holders += 1
    try:
        yield
    finally:
        with _PIN_LOCK:
            _pin_holders -= 1
            if _pin_holders == 0 and any(_pin_saved):
                (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32) = _pin_saved


def conv2d_plain(x: torch.Tensor, w: torch.Tensor, b=None, stride=1,
                 padding=0) -> torch.Tensor:
    """``F.conv2d`` for a card's tensors through PyTorch's own convolution
    (im2col and a cuBLAS GEMM a sample, ``aten::thnn_conv2d``, the route
    ``F.conv2d`` takes with cuDNN off) in float32, not cuDNN; it touches
    no process-wide switch but the TF32 pin.  cuDNN's heuristics reserve a
    workspace as large as free memory allows for the VQVAE decoder's 128 px
    convolutions (28.49 GB for one conv of a d16 decode at batch 8, 36.03
    GB at batch 50), which a generation's CUDA graph pool then holds; the
    plain route takes 1.73 GB and 127.4 ms for the whole batch-8 decode
    where cuDNN takes 28.83 GB and 192.8 ms (``tools/conv_route_probe.py``;
    NVIDIA H100 80GB HBM3, 700 W).  CPU tensors go through ``F.conv2d``
    as they are."""
    if x.device.type == "cpu":
        return F.conv2d(x, w, b, stride=stride, padding=padding)
    with ieee_f32():
        return torch.ops.aten.thnn_conv2d(
            x, w, tuple(w.shape[-2:]), b, (stride, stride),
            (padding, padding))
