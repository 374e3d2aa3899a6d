"""The activation and KV-cache quantizers on the hand-written Hopper
kernels Q1, Q2 and Q3.

In the JAX package every quantizer is plain ``jnp`` under ``jit``, which
XLA fuses into a few loops; the port's plain versions run eagerly, four
PyTorch kernels a grid midpoint (``ops/quantizers.py`` ``snap_to_grid``,
``ops/packing.py`` ``encode_to_grid``).  Each kernel here computes its
plain version's function bit for bit in one launch:

- **Q1** ``csrc/fake_quant_grid.cu``: :func:`fake_quant_fp` (one grid, with
  ``clip_abs``) and :func:`fake_quant_dual`, per group or per token, the
  output in x's dtype (plain: ``quantizers.fake_quant_fp_ref``,
  ``fake_quant_dual_ref``);
- **Q2** ``csrc/grid_codes.cu``: :func:`quant_int_codes` and
  :func:`quant_int_codes_dual` (int8 value codes and float32 scales
  divided by the multiplier; plain: ``packing.quant_int_codes_ref``,
  ``quant_int_codes_dual_ref``), and the grid-index codes of
  :func:`pack_codes` (``pack``: the scale rounded to x's dtype) and of
  :func:`grid_index_codes` (the generic-grid KV codec: a float32 scale per
  row) (plain: ``packing.pack_codes_ref``, ``grid_index_codes_ref``);
- **Q3** ``csrc/fake_quant_int.cu``: :func:`fake_quant_int_sym` and
  :func:`fake_quant_int_asym` (plain: ``quantizers.fake_quant_int_sym_ref``,
  ``fake_quant_int_asym_ref``).

Q1 and Q2 lay a group over as many lanes as it has 16-byte vectors
(``csrc/grid_snap.cuh``: several groups a warp up to 32 vectors, a warp
up to 128, a block of warps beyond), read it once into registers, take
its absmax by shuffles and snap it from the same registers; a dual-grid
value is divided and walked on its own half's table only, the other
half's output being that half's +0, found once a group by the real
division by its scale.  Q3 (and K4's row kernel) take one warp a group
and read it twice.

The public quantizers of ``ops/quantizers.py`` and ``ops/packing.py``
(and the KV codec's ``encode``) call these wrappers, so every caller gets
the kernels with no change at its call site.  On a CPU tensor a wrapper
runs the plain version; on a CUDA tensor it launches its kernel or raises
(a failed build or launch raises; nothing falls back), except on the
named plain routes of :data:`PLAIN_ROUTES`, which need a whole-tensor
absmax first (``granularity="per_tensor"``, ``fake_quant_dual``'s
``clipping_strength``).  The kernels take bfloat16 or float32 ``x``
whose group (or row) is a multiple of 16 bytes; other dtypes and groups
raise on the card.  No kernel has a backward: a CUDA tensor that
autograd would record raises (the STE, the search and generation run
the quantizers under ``torch.no_grad()`` or inference mode).

``grid_launches``, ``codes_launches`` and ``int_launches`` count the
launches of Q1, Q2 and Q3; :func:`card_route` says which kernel (or which
plain route) a quantizer takes on a card.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from functools import partial

import numpy as np
import torch

from fpqvar_tpu_torch.ops import _build
from fpqvar_tpu_torch.ops import grids as G
from fpqvar_tpu_torch.ops import packing as P
from fpqvar_tpu_torch.ops import quantizers as Q

#: number of Q1 (fake_quant_grid) kernel launches in this process
grid_launches = 0
#: number of Q2 (grid_codes) kernel launches in this process
codes_launches = 0
#: number of Q3 (fake_quant_int) kernel launches in this process
int_launches = 0

#: the quantizers' routes on a card that stay plain PyTorch, and why
PLAIN_ROUTES = {
    "per_tensor": "one absmax over the whole tensor first (fp4_pertensor)",
    "clipping_strength": "fake_quant_dual clamps at a share of the whole "
                         "tensor's absmax first (the baselines)",
    "neg_reverse": "fake_quant_neg_reverse (no main-path recipe)",
    "log2": "fake_quant_log2 (fc2_log2; no main-path recipe)",
    "flint": "quantize/baselines.py's FLINT snap (the baselines)",
    "int8_row_codes": "attn_int8's q and softmax-weight codes "
                      "(models/var.py int8_row_codes)",
}

_DTYPES = (torch.bfloat16, torch.float32)
_MAX_GROUPS = 2 ** 31 - 1


@dataclass(frozen=True)
class GridTable:
    """What a kernel needs of one grid: its sorted midpoints (grid units,
    float32), one output per grid value (the value itself for Q1, an
    integer code for Q2), ``f32(1 / max|grid|)``, the code multiplier and
    the kernel's table size (8, 16, 64 or 256 entries)."""

    mids: np.ndarray
    out: np.ndarray
    inv: float
    mult: float
    cap: int

    @property
    def n_mids(self) -> int:
        return len(self.mids)


def _table(grid, out, mult: float) -> GridTable:
    g = np.asarray(grid, dtype=np.float32)
    mids = ((g[1:] + g[:-1]) * np.float32(0.5)).astype(np.float32)
    cap = next(c for c in (8, 16, 64, 256, None) if c is None or len(g) <= c)
    if cap is None:
        raise ValueError(f"a grid of {len(g)} values: the kernels take at "
                         "most 256")
    return GridTable(np.ascontiguousarray(mids), np.ascontiguousarray(out),
                     Q.inv_max(g), float(mult), cap)


@functools.lru_cache(maxsize=None)
def value_table(fmt: str, half: str = None) -> GridTable:
    """Q1's table of ``G.GRIDS[fmt]``, or of the ``half`` ("neg" or
    "pos") of ``G.DUAL_GRIDS[fmt]``: the grid values."""
    grid = (G.GRIDS[fmt] if half is None
            else G.DUAL_GRIDS[fmt][("neg", "pos").index(half)])
    return _table(grid, np.asarray(grid, dtype=np.float32), 1.0)


@functools.lru_cache(maxsize=None)
def code_table(fmt: str, half: str = None) -> GridTable:
    """Q2's value-code table: ``round(grid * mult)`` with ``mult`` of
    ``P.CODE_MULT`` (or a half of ``P.DUAL_CODE_MULT``)."""
    if half is None:
        grid, mult = G.GRIDS[fmt], P.CODE_MULT[fmt]
    else:
        i = ("neg", "pos").index(half)
        grid, mult = G.DUAL_GRIDS[fmt][i], P.DUAL_CODE_MULT[fmt][i]
    g = np.asarray(grid, dtype=np.float32)
    return _table(g, np.round(g * np.float32(mult)).astype(np.int32), mult)


@functools.lru_cache(maxsize=None)
def index_table(fmt: str) -> GridTable:
    """Q2's grid-index table: index i as ``.to(int8)`` keeps it (a grid of
    more than 128 values wraps past 127), multiplier 1."""
    n = len(G.GRIDS[fmt])
    idx = np.arange(n, dtype=np.int64).astype(np.int8).astype(np.int32)
    return _table(G.GRIDS[fmt], idx, 1.0)


# ---------------------------------------------------------------------------
# Operand preparation and the launches
# ---------------------------------------------------------------------------

def _on_card(x: torch.Tensor) -> bool:
    """The kernel route: any tensor not on the CPU (which a kernel takes,
    or on which it raises)."""
    return x.device.type != "cpu"


def _group_size(x: torch.Tensor, granularity: str, group_size: int) -> int:
    if granularity in ("per_token", "per_channel"):
        return x.shape[-1]
    if granularity == "per_group":
        if x.shape[-1] % group_size:
            raise ValueError(f"last dim {x.shape[-1]} not divisible by "
                             f"group_size {group_size}")
        return group_size
    raise ValueError(f"unknown granularity {granularity!r}")


def _operand(x: torch.Tensor, gs: int, what: str):
    """``x`` as the kernels read it: contiguous and 16-byte aligned (a
    copy where it is not), bfloat16 or float32, groups of ``gs`` values a
    multiple of 16 bytes; raises on what they do not take, and on a
    tensor that autograd would record (no kernel has a backward).
    Returns ``(x, n_groups)``."""
    if x.dtype not in _DTYPES:
        raise TypeError(f"{what}: the kernel takes bfloat16 or float32, "
                        f"got {x.dtype}")
    if torch.is_grad_enabled() and x.requires_grad:
        raise RuntimeError(
            f"{what}: the kernel has no backward; quantize under "
            "torch.no_grad() (the STE takes its delta that way)")
    if gs <= 0 or (gs * x.element_size()) % 16:
        raise ValueError(f"{what}: groups of {gs} {x.dtype} values are not "
                         "a multiple of 16 bytes, which the kernel reads")
    x = x.contiguous()
    if x.data_ptr() % 16:
        x = x.clone()
    n = x.numel() // gs
    if n > _MAX_GROUPS:
        raise ValueError(f"{what}: {n} groups exceed the kernel's int32 "
                         "count")
    return x, n


def _grid_lib():
    """``csrc/fake_quant_grid.cu``: x, y, n_groups, gs, x_bf16, dual, then
    tables a and b (midpoints, values: host pointers; n_mids; inv), clip,
    has_clip."""
    tab = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_float]
    return _build.load("fake_quant_grid",
                       [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 + tab * 2
                       + [ctypes.c_float, ctypes.c_int])


def _codes_lib():
    """``csrc/grid_codes.cu``: x, codes a, scales a, codes b, scales b,
    n_groups, gs, x_bf16, dual, round_scale, then tables a and b
    (midpoints, codes: host pointers; n_mids; inv; mult)."""
    tab = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
           ctypes.c_float]
    return _build.load("grid_codes",
                       [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + tab * 2)


def _int_lib():
    """``csrc/fake_quant_int.cu``: x, y, n_groups, gs, x_bf16, asym,
    q_min, q_max, inv, eps."""
    return _build.load("fake_quant_int",
                       [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4
                       + [ctypes.c_float] * 4)


def _tab_args(t: GridTable, codes: bool):
    args = [t.mids.ctypes.data, t.out.ctypes.data, t.n_mids, t.inv]
    return args + [t.mult] if codes else args


def _run_q1(x, n: int, gs: int, fmt: str, dual: bool, clip) -> torch.Tensor:
    """Launch Q1 on ``x`` (prepared, ``n`` groups of ``gs``) -> y."""
    global grid_launches
    y = torch.empty_like(x)
    if dual:
        ta, tb = value_table(fmt, "neg"), value_table(fmt, "pos")
    else:
        ta = tb = value_table(fmt)
    _build.launch(_grid_lib(), "fake_quant_grid", x.device, x.data_ptr(),
                  y.data_ptr(), n, gs, int(x.dtype == torch.bfloat16),
                  int(dual), *_tab_args(ta, False), *_tab_args(tb, False),
                  0.0 if clip is None else float(clip), int(clip is not None))
    grid_launches += 1
    return y


def _run_q2(x, n: int, gs: int, tables, round_scale: bool) -> tuple:
    """Launch Q2 on ``x`` (prepared) with one table (codes, scales) or two
    (the dual grid's negative and positive halves: codes and scales of
    each) -> the int8 codes (x's shape) and f32 scales ``[n]`` of each
    table."""
    global codes_launches
    outs = []
    for _ in tables:
        outs += [torch.empty(x.shape, dtype=torch.int8, device=x.device),
                 torch.empty((n,), dtype=torch.float32, device=x.device)]
    ptrs = [t.data_ptr() for t in outs]
    ptrs += ptrs if len(tables) == 1 else []
    ta, tb = tables[0], tables[-1]
    _build.launch(_codes_lib(), "grid_codes", x.device, x.data_ptr(), *ptrs,
                  n, gs, int(x.dtype == torch.bfloat16),
                  int(len(tables) == 2), int(round_scale),
                  *_tab_args(ta, True), *_tab_args(tb, True))
    codes_launches += 1
    return tuple(outs)


def _run_q3(x, n: int, gs: int, n_bits: int, asym: bool,
            eps: float) -> torch.Tensor:
    """Launch Q3 on ``x`` (prepared) -> y."""
    global int_launches
    q_min, q_max = Q._int_range(n_bits)
    inv = Q.inv(q_max - q_min) if asym else Q.inv(q_max)
    y = torch.empty_like(x)
    _build.launch(_int_lib(), "fake_quant_int", x.device, x.data_ptr(),
                  y.data_ptr(), n, gs, int(x.dtype == torch.bfloat16),
                  int(asym), float(q_min), float(q_max), inv, float(eps))
    int_launches += 1
    return y


# ---------------------------------------------------------------------------
# Q1: fake quantization onto a grid
# ---------------------------------------------------------------------------

def fake_quant_fp(x: torch.Tensor, fmt: str, *,
                  granularity: str = "per_group", group_size: int = 128,
                  clip_abs=None) -> torch.Tensor:
    """``quantizers.fake_quant_fp``: on a card Q1, or the plain version
    ``per_tensor`` (:data:`PLAIN_ROUTES`)."""
    if not _on_card(x) or granularity == "per_tensor":
        return Q.fake_quant_fp_ref(x, fmt, granularity=granularity,
                                   group_size=group_size, clip_abs=clip_abs)
    gs = _group_size(x, granularity, group_size)
    xc, n = _operand(x, gs, "fake_quant_fp")
    if n == 0:
        return torch.empty_like(x)
    return _run_q1(xc, n, gs, fmt, False, clip_abs).reshape(x.shape)


def fake_quant_dual(x: torch.Tensor, fmt: str, *,
                    granularity: str = "per_group", group_size: int = 128,
                    clipping_strength=None) -> torch.Tensor:
    """``quantizers.fake_quant_dual``: on a card Q1's dual-grid kernel, or
    the plain version ``per_tensor`` or with ``clipping_strength``
    (:data:`PLAIN_ROUTES`)."""
    if (not _on_card(x) or granularity == "per_tensor"
            or clipping_strength is not None):
        return Q.fake_quant_dual_ref(x, fmt, granularity=granularity,
                                     group_size=group_size,
                                     clipping_strength=clipping_strength)
    gs = _group_size(x, granularity, group_size)
    xc, n = _operand(x, gs, "fake_quant_dual")
    if n == 0:
        return torch.empty_like(x)
    return _run_q1(xc, n, gs, fmt, True, None).reshape(x.shape)


# ---------------------------------------------------------------------------
# Q3: linear INT fake quantization
# ---------------------------------------------------------------------------

def fake_quant_int_sym(x: torch.Tensor, n_bits: int, *,
                       granularity: str = "per_token", group_size: int = 128,
                       scale_eps: float = 1e-5) -> torch.Tensor:
    """``quantizers.fake_quant_int_sym``: on a card Q3, or the plain
    version ``per_tensor`` (:data:`PLAIN_ROUTES`)."""
    if not _on_card(x) or granularity == "per_tensor":
        return Q.fake_quant_int_sym_ref(x, n_bits, granularity=granularity,
                                        group_size=group_size,
                                        scale_eps=scale_eps)
    gs = _group_size(x, granularity, group_size)
    xc, n = _operand(x, gs, "fake_quant_int_sym")
    if n == 0:
        return torch.empty_like(x)
    return _run_q3(xc, n, gs, n_bits, False, scale_eps).reshape(x.shape)


def fake_quant_int_asym(x: torch.Tensor, n_bits: int, *,
                        granularity: str = "per_token", group_size: int = 128,
                        scale_eps: float = 1e-5) -> torch.Tensor:
    """``quantizers.fake_quant_int_asym``: on a card Q3, or the plain
    version ``per_tensor`` (:data:`PLAIN_ROUTES`)."""
    if not _on_card(x) or granularity == "per_tensor":
        return Q.fake_quant_int_asym_ref(x, n_bits, granularity=granularity,
                                         group_size=group_size,
                                         scale_eps=scale_eps)
    gs = _group_size(x, granularity, group_size)
    xc, n = _operand(x, gs, "fake_quant_int_asym")
    if n == 0:
        return torch.empty_like(x)
    return _run_q3(xc, n, gs, n_bits, True, scale_eps).reshape(x.shape)


# ---------------------------------------------------------------------------
# Q2: integer codes
# ---------------------------------------------------------------------------

def _scales_shape(x: torch.Tensor, gs: int) -> tuple:
    return tuple(x.shape[:-1]) + (x.shape[-1] // gs,)


def quant_int_codes(x: torch.Tensor, fmt: str, group_size: int = 128):
    """``packing.quant_int_codes``: on a card Q2 -> (codes int8 ``(...,
    K)``, scales f32 ``(..., G)``)."""
    if not _on_card(x):
        return P.quant_int_codes_ref(x, fmt, group_size)
    tab = code_table(fmt)
    gs = _group_size(x, "per_group", group_size)
    xc, n = _operand(x, gs, "quant_int_codes")
    shape = _scales_shape(x, gs)
    if n == 0:
        return (torch.empty(x.shape, dtype=torch.int8, device=x.device),
                torch.empty(shape, dtype=torch.float32, device=x.device))
    codes, scales = _run_q2(xc, n, gs, (tab,), False)
    return codes.reshape(x.shape), scales.reshape(shape)


def quant_int_codes_dual(x: torch.Tensor, fmt: str, group_size: int = 128):
    """``packing.quant_int_codes_dual``: on a card Q2's dual-grid kernel
    -> (codes_neg, scales_neg, codes_pos, scales_pos)."""
    if not _on_card(x):
        return P.quant_int_codes_dual_ref(x, fmt, group_size)
    tabs = (code_table(fmt, "neg"), code_table(fmt, "pos"))
    gs = _group_size(x, "per_group", group_size)
    xc, n = _operand(x, gs, "quant_int_codes_dual")
    shape = _scales_shape(x, gs)
    if n == 0:
        c = torch.empty(x.shape, dtype=torch.int8, device=x.device)
        s = torch.empty(shape, dtype=torch.float32, device=x.device)
        return c, s, c.clone(), s.clone()
    cn, sn, cp, sp = _run_q2(xc, n, gs, tabs, False)
    return (cn.reshape(x.shape), sn.reshape(shape), cp.reshape(x.shape),
            sp.reshape(shape))


def pack_codes(x: torch.Tensor, fmt: str, group_size: int = 128):
    """``pack``'s quantize stage: on a card Q2 with the grid-index table
    and the scale rounded to x's dtype -> (codes ``[..., K]``: int32 on the
    CPU, int8 on a card, the same bytes once cast to int8; scales f32
    ``[..., G, 1]``)."""
    if not _on_card(x):
        return P.pack_codes_ref(x, fmt, group_size)
    tab = index_table(fmt)
    gs = _group_size(x, "per_group", group_size)
    xc, n = _operand(x, gs, "pack")
    shape = _scales_shape(x, gs) + (1,)
    if n == 0:
        return (torch.empty(x.shape, dtype=torch.int8, device=x.device),
                torch.empty(shape, dtype=torch.float32, device=x.device))
    codes, scales = _run_q2(xc, n, gs, (tab,), True)
    return codes.reshape(x.shape), scales.reshape(shape)


def grid_index_codes(x: torch.Tensor, fmt: str):
    """The generic-grid KV codec's encode: on a card Q2 with the
    grid-index table, one float32 scale a row of the last dim -> (codes
    int8 ``[..., c]``, scales f32 ``[..., 1]``)."""
    if not _on_card(x):
        return P.grid_index_codes_ref(x, fmt)
    tab = index_table(fmt)
    gs = x.shape[-1]
    xc, n = _operand(x, gs, "grid_index_codes")
    shape = tuple(x.shape[:-1]) + (1,)
    if n == 0:
        return (torch.empty(x.shape, dtype=torch.int8, device=x.device),
                torch.empty(shape, dtype=torch.float32, device=x.device))
    codes, scales = _run_q2(xc, n, gs, (tab,), False)
    return codes.reshape(x.shape), scales.reshape(shape)


# ---------------------------------------------------------------------------
# Routes
# ---------------------------------------------------------------------------

#: plain function -> the kernel its public wrapper launches on a card
_KERNEL_OF = {"fake_quant_fp": "Q1", "fake_quant_dual": "Q1",
              "fake_quant_int_sym": "Q3", "fake_quant_int_asym": "Q3",
              "quant_int_codes": "Q2", "quant_int_codes_dual": "Q2"}


def card_route(quantizer) -> str:
    """The kernel (``"Q1"``, ``"Q2"``, ``"Q3"``) that ``quantizer`` runs on
    a card, or ``"plain: <key of PLAIN_ROUTES>"``.  ``quantizer`` is what
    the runtime builds: a ``functools.partial`` of a public quantizer
    (``make_act_quantizer``, ``fake_quant_kv``) or a packed KV codec
    (``quantize.runtime.KVCodec``, whose every encode runs Q2)."""
    if hasattr(quantizer, "encode") and hasattr(quantizer, "value_codes"):
        return "Q2"
    func = quantizer.func if isinstance(quantizer, partial) else quantizer
    kw = quantizer.keywords if isinstance(quantizer, partial) else {}
    name = getattr(func, "__name__", "")
    if name == "fake_quant_kv":
        return card_route(_kv_quantizer(kw["qcfg"]))
    if name == "fake_quant_neg_reverse":
        return "plain: neg_reverse"
    if name == "fake_quant_log2":
        return "plain: log2"
    if name not in _KERNEL_OF:
        raise ValueError(f"no route known for {quantizer!r}")
    if kw.get("granularity") == "per_tensor":
        return "plain: per_tensor"
    if kw.get("clipping_strength") is not None:
        return "plain: clipping_strength"
    return _KERNEL_OF[name]


def _kv_quantizer(qcfg):
    """The public quantizer that ``fake_quant_kv`` calls for ``qcfg``."""
    fmt = qcfg.resolved_kv_format()
    if fmt == "int_sym":
        return partial(Q.fake_quant_int_sym, granularity="per_token")
    if fmt in G.DUAL_GRIDS:
        return partial(Q.fake_quant_dual, fmt=fmt, granularity="per_token")
    return partial(Q.fake_quant_fp, fmt=fmt)

