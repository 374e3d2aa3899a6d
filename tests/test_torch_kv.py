"""The packed KV cache of the port (``int8kv``, ``int8att``) against the JAX
package.

- The codec: codes and scales of ``make_kv_codec(fmt).encode`` equal, bit
  for bit, JAX's under ``jax.jit`` (the form JAX's engine runs), and the
  decoded values too, for the value-code formats ``fp_e2``, ``fp6_e2m3``
  and ``fp_e3`` and the grid-index format ``fp6_e3m2``, on float32 and
  bfloat16 rows of widely spread magnitudes with an all-zero row.  A grid
  of more than 128 values (``fp8_e4m3``) decodes every index in the port;
  JAX's one-hot decode gives 0 past index 127.
- ``attn_int8``'s quantizer: q's codes and scales per (token, head) and
  the softmax weights' per row equal JAX's jitted ones, on rows where a
  division by 127 and ``x f32(1/127)`` differ (XLA's rewrite under ``jit``)
  and on rows whose quotients are exact ties (half to even).
- The contractions: float32 matmuls of the codes are exact up to the 2^24
  bound, checked against int64 products at the bound, and
  ``check_int8_attention_exact`` raises past it.
- One ``block_forward`` with a packed cache at ``var_tiny`` width 128
  under ``int8kv``, ``int8att`` and ``int8kv`` with an fp6_e3m2 cache, at
  the first scale and the last: the cache rows of earlier steps stay as
  JAX's segments held them, the new rows' codes equal JAX's segment, and
  their scales agree within 4 float32 ulps (the keys and values come out
  of float32 sums, layer norm and l2 norm, in another order); the block
  output within 2e-5 (values of order 1), as
  ``test_torch_var.test_block_forward_step_with_cache`` holds it.
- A1 (``ops/packed_attention.py``), the card's kernel for the value-code
  branch: its two-pass arithmetic mirrored tile by tile in this file
  against the whole-tensor chain (within ``packed_attention.tolerance``
  and equal on all but a few outputs, at l = 1, ragged last tiles and
  VAR-d30's last scale, bfloat16 and float32 q), the CPU route equal to
  the chain, the warps a block from l, and the operands the kernel
  refuses.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fpqvar_tpu.config import bench_recipes as jax_recipes
from fpqvar_tpu.config import var_tiny as jax_var_tiny
from fpqvar_tpu.models import var as JV
from fpqvar_tpu.quantize import quantize_var_params as jax_quantize
from fpqvar_tpu.quantize.runtime import build_runtime as jax_runtime
from fpqvar_tpu.quantize.runtime import make_kv_codec as jax_kv_codec

from fpqvar_tpu_torch.config import bench_recipes, var_tiny
from fpqvar_tpu_torch.models import var as V
from fpqvar_tpu_torch.ops import grids as G
from fpqvar_tpu_torch.quantize import build_runtime
from fpqvar_tpu_torch.quantize.runtime import make_kv_codec
from fpqvar_tpu_torch.utils.bridge import to_torch
from torch_threads import one_torch_thread  # noqa: F401


def _rows(seed, shape):
    """Gaussian rows of ``shape`` scaled per row over six decades, the
    first row all zero."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape) * 10.0 ** rng.uniform(
        -3, 3, shape[:-1] + (1,))
    x = x.astype(np.float32)
    x.reshape(-1, shape[-1])[0] = 0.0
    return x


def _port(a, dtype):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fmt", ["fp_e2", "fp6_e2m3", "fp_e3", "fp6_e3m2"])
def test_kv_codec_bit_equal_to_jax(fmt, dtype):
    x = _rows(1, (3, 7, 2, 64))
    jx = jnp.asarray(x).astype(dtype)
    theirs, ours = jax_kv_codec(fmt), make_kv_codec(fmt)
    assert ours.value_codes == theirs.value_codes == (fmt != "fp6_e3m2")
    jc, js = jax.jit(theirs.encode)(jx)
    tc, ts = ours.encode(_port(np.asarray(jx.astype(jnp.float32)),
                               getattr(torch, dtype)))
    assert tc.dtype == torch.int8 and ts.dtype == torch.float32
    assert tuple(ts.shape) == (3, 7, 2, 1)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert ts.numpy().tobytes() == np.asarray(js).tobytes()
    jd = np.asarray(jax.jit(theirs.decode)(jc, js))
    assert ours.decode(tc, ts).numpy().tobytes() == jd.tobytes()
    if ours.value_codes:
        assert int(tc.abs().max()) <= ours.max_code


def test_kv_codec_decodes_grid_indices_past_int8():
    """fp8_e4m3 has 255 grid values: its codes keep the index's low byte,
    and the port reads it back as 0..255, so decode(encode(x)) is the
    nearest grid value times the row's scale everywhere.  JAX's decode
    one-hot-encodes the signed code and gives 0 for every index above 127
    (the positive half of the grid); its codes equal the port's."""
    fmt, grid = "fp8_e4m3", G.GRIDS["fp8_e4m3"]
    x = _rows(2, (64, 64))
    ours, theirs = make_kv_codec(fmt), jax_kv_codec(fmt)
    tc, ts = ours.encode(torch.from_numpy(x))
    jc, js = jax.jit(theirs.encode)(jnp.asarray(x))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    mids = (grid[1:] + grid[:-1]) * np.float32(0.5)
    idx = (x[..., None] / ts.numpy()[..., None] >= mids).sum(-1)
    want = grid[idx] * ts.numpy()
    np.testing.assert_array_equal(ours.decode(tc, ts).numpy(), want)
    jd = np.asarray(jax.jit(theirs.decode)(jc, js))
    past = idx > 127
    assert past.mean() > 0.3
    np.testing.assert_array_equal(jd[~past], want[~past])
    assert not jd[past].any()


@jax.jit
def _jax_int8_row_codes(t):
    """JAX's ``attn_int8`` quantizer (``fpqvar_tpu/models/var.py``, the
    lines of ``qc`` / ``pc``), jitted as JAX's engine runs it."""
    tf = t.astype(jnp.float32)
    a = jnp.max(jnp.abs(tf), axis=-1, keepdims=True)
    s = jnp.where(a > 0, a / 127.0, 1.0)
    return jnp.round(tf / s).astype(jnp.int8), s


@pytest.mark.parametrize("what", ["q", "p"])
def test_attn_int8_codes_bit_equal_to_jax(what):
    """q rows [B, l, H, c] in bfloat16 (as generation runs on the card), and
    softmax weights with v's scales folded in, [B, H, l, M] in float32.
    Some rows have an absmax of 127 * 2^k, whose scale is 2^k exactly, and
    values at (n + 1/2) * 2^k, exact ties of the rounding."""
    rng = np.random.default_rng(3 if what == "q" else 4)
    if what == "q":
        t = rng.standard_normal((2, 9, 2, 64)).astype(np.float32)
    else:
        s = rng.standard_normal((2, 2, 9, 14)) * 4.0
        p = np.exp(s - s.max(-1, keepdims=True))
        p /= p.sum(-1, keepdims=True)
        t = (p * rng.uniform(0.01, 0.1, (2, 2, 1, 14))).astype(np.float32)
    flat = t.reshape(-1, t.shape[-1])
    flat[0] = 0.0
    for r, k in ((1, 0), (2, -3), (3, -6)):
        flat[r] = 0.0
        flat[r, 0] = 127.0 * 2.0 ** k
        flat[r, 1:9] = (np.arange(8) - 3.5) * 2.0 ** k     # ties
    jt = jnp.asarray(t)
    if what == "q":
        jt = jt.astype(jnp.bfloat16)
    jc, js = _jax_int8_row_codes(jt)
    tc, ts = V.int8_row_codes(_port(np.asarray(jt.astype(jnp.float32)),
                                    torch.bfloat16 if what == "q"
                                    else torch.float32))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert ts.numpy().tobytes() == np.asarray(js).tobytes()
    # the rows that tell XLA's multiply from a true division are there
    amax = np.abs(np.asarray(jt.astype(jnp.float32))).max(-1, keepdims=True)
    div = np.where(amax > 0, amax / np.float32(127.0), 1.0)
    assert (div != ts.numpy()).any()
    assert np.asarray(jc).reshape(-1, t.shape[-1])[1, 1:9].tolist() == [
        -4, -2, -2, 0, 0, 2, 2, 4]


def test_int8_contractions_exact_to_the_bound():
    """At the bound, 127 * max_code * M <= 2^24, a float32 matmul of the
    codes equals the int64 product; one more cached token raises."""
    head_dim, max_code = 64, 64                  # fp_e3's largest code
    m = V.EXACT_F32_INT // (127 * max_code)      # 2064 tokens
    V.check_int8_attention_exact(head_dim, m, max_code)
    V.check_int8_attention_exact(head_dim, 680, 12)     # VAR-d16, fp_e2
    with pytest.raises(ValueError, match="2\\^24"):
        V.check_int8_attention_exact(head_dim, m + 1, max_code)
    rng = np.random.default_rng(7)
    pc = rng.integers(-127, 128, (3, m), dtype=np.int64)
    pc[0] = 127
    vc = rng.integers(-max_code, max_code + 1, (m, head_dim),
                      dtype=np.int64)
    vc[:, 0] = max_code
    got = V._int_matmul(torch.from_numpy(pc).to(torch.int8),
                        torch.from_numpy(vc).to(torch.int8))
    np.testing.assert_array_equal(got.numpy().astype(np.int64), pc @ vc)
    assert got[0, 0] == 127 * max_code * m
    q = torch.zeros((1, 1, 1, head_dim))
    kc = torch.zeros((1, 1, m + 1, head_dim), dtype=torch.int8)
    ks = torch.ones((1, 1, m + 1))
    with pytest.raises(ValueError, match="attn_int8"):
        V._int8_attention(q, kc, ks, kc, ks, max_code, None)


def test_runtime_builds_the_kv_codec():
    for mode, attn in (("int8kv", False), ("int8att", True)):
        rt = build_runtime(bench_recipes()[mode], device="cpu")
        jrt = jax_runtime(jax_recipes()[mode], 2, 128)
        assert rt.kv_codec.fmt == jrt.kv_codec.fmt == "fp_e2"
        assert rt.kv_codec.value_codes and rt.kv_codec.max_code == 12
        assert rt.attn_int8 is jrt.attn_int8 is attn
    assert build_runtime(bench_recipes()["int8ch"],
                         device="cpu").kv_codec is None
    rt = build_runtime(bench_recipes()["int8kv"].replace(
        kv_bit=6, kv_format="fp6_e3m2"), device="cpu")
    assert rt.kv_codec.fmt == "fp6_e3m2" and not rt.kv_codec.value_codes


@functools.lru_cache(maxsize=None)
def _setup(mode):
    width = 128
    jcfg = dataclasses.replace(jax_var_tiny(), embed_dim=width,
                               num_heads=width // 64)
    cfg = dataclasses.replace(var_tiny(), embed_dim=width,
                              num_heads=width // 64)
    jparams = jax.jit(functools.partial(
        JV.init_var_params, cfg=jcfg, adaln_gamma_std=0.02))(
        jax.random.PRNGKey(0))
    rng = np.random.default_rng(5)
    galt = tuple(np.exp(0.1 * rng.standard_normal((cfg.depth, width)))
                 .astype(np.float32) for _ in range(2))
    base = "int8kv" if mode == "int8kv_e3m2" else mode
    jq, q = jax_recipes()[base], bench_recipes()[base]
    if mode == "int8kv_e3m2":
        jq = jq.replace(kv_format="fp6_e3m2", kv_bit=6)
        q = q.replace(kv_format="fp6_e3m2", kv_bit=6)
    jqp = jax_quantize(jparams, jcfg, jq, galt=galt)
    tqp = to_torch(jax.tree_util.tree_map(np.asarray, jqp), "cpu")
    return (jcfg, cfg, jqp, tqp, jax_runtime(jq, jcfg.depth, width),
            build_runtime(q, cfg.depth, width, device="cpu"))


def _ulps(a, b):
    """Distance in float32 ulps of two positive float32 arrays."""
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


@pytest.mark.parametrize("cur", [0, 5])
@pytest.mark.parametrize("mode", ["int8kv", "int8att", "int8kv_e3m2"])
def test_packed_block_forward_matches_jax(mode, cur):
    """cur 0: the first scale (one token, an empty cache); cur 5: the last
    scale of ``var_tiny`` (9 new tokens over 5 cached ones, two earlier
    segments)."""
    jcfg, cfg, jqp, tqp, jrt, qrt = _setup(mode)
    b, h, hd = 2, cfg.heads, cfg.head_dim
    starts = np.cumsum([0] + [pn * pn for pn in cfg.patch_nums])
    si = list(starts).index(cur)
    l = cfg.patch_nums[si] ** 2
    rng = np.random.default_rng(6)
    x = rng.standard_normal((b, l, cfg.width)).astype(np.float32)
    mod = (rng.standard_normal((6, b, 1, cfg.width)) * 0.1).astype(np.float32)
    kv = [rng.standard_normal((b, cur, h, hd)).astype(np.float32)
          for _ in range(2)]
    encode = jax.jit(jrt.kv_codec.encode)
    segs = []
    for s in range(si):
        seg = {}
        for t, codes, scales in zip(kv, ("kc", "vc"), ("ks", "vs")):
            c, sc = encode(jnp.asarray(t[:, starts[s]:starts[s + 1]]))
            seg[codes] = c.transpose(0, 2, 1, 3).reshape(b, h, -1)
            seg[scales] = sc[..., 0].transpose(0, 2, 1)
        segs.append(seg)
    i = 1
    jbp = jax.tree_util.tree_map(lambda a: a[i], jqp["blocks"])

    @jax.jit
    def theirs_fn(x, mod, segs):
        return JV.block_forward(x, jbp, mod, jrt, jcfg, {"segs": segs},
                                cur)[:2]

    jx, new = theirs_fn(jnp.asarray(x), jnp.asarray(mod), tuple(segs))
    cache = {kn: leaf[0] for kn, leaf in V.init_kv_cache(
        cfg, b, torch.float32, "cpu", qrt.kv_codec).items()}
    for s, seg in enumerate(segs):
        rows = slice(starts[s], starts[s + 1])
        for kn in ("kc", "vc"):
            cache[kn][:, :, rows] = torch.from_numpy(
                np.array(seg[kn])).reshape(b, h, -1, hd)
        for kn in ("ks", "vs"):
            cache[kn][:, :, rows] = torch.from_numpy(np.array(seg[kn]))
    ours = V.block_forward(torch.from_numpy(x),
                           V.block_params(tqp["blocks"], i),
                           torch.from_numpy(mod), qrt, cfg, cache, cur)
    np.testing.assert_allclose(ours.numpy(), np.asarray(jx), rtol=0,
                               atol=2e-5)
    for kn in ("kc", "vc", "ks", "vs"):
        js = [np.asarray(seg[kn]) for seg in segs] + [np.asarray(new[kn])]
        theirs = np.concatenate(js, axis=2).reshape(
            cache[kn][:, :, :cur + l].shape)
        got = cache[kn][:, :, :cur + l].numpy()
        np.testing.assert_array_equal(got[:, :, :cur], theirs[:, :, :cur])
        if kn in ("kc", "vc"):
            np.testing.assert_array_equal(got, theirs)
        else:
            assert _ulps(got[:, :, cur:], theirs[:, :, cur:]).max() <= 4


# ---------------------------------------------------------------------------
# A1 (ops/packed_attention.py): the kernel's arithmetic against the chain
# ---------------------------------------------------------------------------

def _a1_mirror(q, kc, ks, vc, vs, tile=64):
    """A1's arithmetic, tile by tile over the cached tokens, in two
    passes: float32 scores ``(q . kc) * ks``, each row's running max and
    sum of ``exp(s - max)`` (pass 0), then the scores again, the weights
    ``exp(s - max) / sum * vs`` rounded to q's dtype and their product
    with ``vc`` summed in float32, the output rounded to q's dtype (pass
    1).  (A float32 q's three bf16 parts sum to q exactly, as its
    weights' do: the same float32 products.)"""
    b, l, h, c = q.shape
    qf = q.transpose(1, 2).to(torch.float32)
    tiles = [slice(j, j + tile) for j in range(0, kc.shape[2], tile)]

    def scores(t):
        return (qf @ kc[:, :, t].float().transpose(-1, -2)) * ks[:, :, None, t]

    mx = torch.full((b, h, l, 1), -torch.inf)
    tot = torch.zeros((b, h, l, 1))
    for t in tiles:
        s = scores(t)
        new = torch.maximum(mx, s.amax(-1, keepdim=True))
        tot = tot * torch.exp(mx - new) + torch.exp(s - new).sum(
            -1, keepdim=True)
        mx = new
    acc = torch.zeros((b, h, l, c))
    for t in tiles:
        w = (torch.exp(scores(t) - mx) / tot * vs[:, :, None, t]).to(q.dtype)
        acc = acc + w.to(torch.float32) @ vc[:, :, t].float()
    return acc.to(q.dtype).transpose(1, 2).reshape(b, l, h * c)


def _a1_operands(l, cur, dtype, heads=3, rows=4, seed=0, headroom=0):
    """q as the block makes it (l2-normalised rows times a head scale up
    to 20, so some softmax rows are peaked) and fp_e2 codes and scales of
    Gaussian keys and values through the int8kv codec, over ``cur + l``
    cached tokens in a cache of ``cur + l + headroom`` rows."""
    from fpqvar_tpu_torch.ops import packed_attention as PA

    g = torch.Generator().manual_seed(seed)
    hd, end = PA.HEAD_DIM, cur + l
    q = torch.randn((rows, l, heads, hd), generator=g)
    q = q / q.norm(dim=-1, keepdim=True) * torch.tensor(
        [1.0, 5.0, 20.0][:heads]).reshape(1, 1, heads, 1)
    codec = make_kv_codec("fp_e2")
    cache = {}
    for codes, scales in (("kc", "ks"), ("vc", "vs")):
        t = torch.randn((rows, end, heads, hd), generator=g)
        tc, ts = codec.encode(t)
        cache[codes] = torch.zeros((rows, heads, end + headroom, hd),
                                   dtype=torch.int8)
        cache[scales] = torch.zeros((rows, heads, end + headroom))
        cache[codes][:, :, :end] = tc.transpose(1, 2)
        cache[scales][:, :, :end] = ts[..., 0].transpose(1, 2)
    return (q.to(dtype), cache["kc"][:, :, :end], cache["ks"][:, :, :end],
            cache["vc"][:, :, :end], cache["vs"][:, :, :end])


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("l,cur", [(1, 0), (4, 1), (16, 14), (37, 30),
                                   (64, 64), (100, 155), (256, 424)])
def test_a1_reformulation_within_its_tolerance(l, cur, dtype):
    """The two tiled passes (A1's arithmetic) against the whole-tensor
    chain: within ``packed_attention.tolerance``, and, as the weights
    round at the chain's values, equal to it but for outputs whose sums
    land by an ulp on the other side of a rounding (under 1% of them
    here): l = 1 over one token, ragged last tiles of 67 and 255 tokens,
    whole tiles (128), the VAR-d30 last scale (256 over 680).  The same
    chain with the weights rounded before the division by the row sum
    (``exp(s - max) * vs``, one pass) moves a third or more of them."""
    from fpqvar_tpu_torch.ops import packed_attention as PA

    ops = _a1_operands(l, cur, getattr(torch, dtype), headroom=5)
    want = PA.packed_attention_ref(*ops)
    got = _a1_mirror(*ops)
    assert got.dtype == want.dtype == ops[0].dtype
    assert got.shape == (4, l, 3 * PA.HEAD_DIM)
    gap = (got.float() - want.float()).abs()
    assert bool(torch.isfinite(got).all())
    assert bool((gap <= PA.tolerance(*ops)).all())
    if dtype == "bfloat16":
        assert float((gap > 0).float().mean()) < 0.01
        q, kc, ks, vc, vs = ops
        p = torch.softmax((q.transpose(1, 2).float() @ kc.float().transpose(
            -1, -2)) * ks[:, :, None, :], dim=-1)
        e = p * p.amax(-1, keepdim=True).reciprocal()
        one_pass = (((e * vs[:, :, None, :]).to(q.dtype).float()
                     @ vc.float()) / e.sum(-1, keepdim=True)).to(q.dtype)
        moved = one_pass.transpose(1, 2).reshape(want.shape) != want
        assert cur + l == 1 or float(moved.float().mean()) > 0.3


@pytest.mark.parametrize("l,cur", [(1, 0), (16, 14), (100, 155),
                                   (256, 424)])
def test_a1_tolerance_covers_the_chains_own_rounding(l, cur):
    """``packed_attention.tolerance`` at float32 holds the float32 chain
    to the same chain in float64 (the exact sums, near enough): the bound
    counts the chain's rounding as well as A1's, so a kernel whose sums
    were exact would meet it too."""
    from fpqvar_tpu_torch.ops import packed_attention as PA

    ops = _a1_operands(l, cur, torch.float32, headroom=5)
    want = PA.packed_attention_ref(*[t.double() if t.is_floating_point()
                                     else t for t in ops])
    gap = (PA.packed_attention_ref(*ops).double() - want).abs()
    assert bool((gap <= PA.tolerance(*ops)).all())


def test_a1_cpu_route_is_the_plain_chain():
    """On the CPU ``packed_attention`` is the chain itself (bit for bit,
    with an ``attn_bias`` too) and launches nothing; the block's
    value-code branch goes through it."""
    from fpqvar_tpu_torch.ops import packed_attention as PA

    ops = _a1_operands(9, 5, torch.bfloat16, headroom=2)
    before = PA.attn_launches
    assert torch.equal(PA.packed_attention(*ops),
                       PA.packed_attention_ref(*ops))
    bias = torch.randn((1, 1, 9, 14))
    assert torch.equal(PA.packed_attention(*ops, attn_bias=bias),
                       PA.packed_attention_ref(*ops, attn_bias=bias))
    assert PA.attn_launches == before
    assert V.packed_attention is PA.packed_attention


@pytest.mark.parametrize("l,warps", [(1, 1), (4, 1), (16, 1), (17, 2),
                                     (100, 7), (128, 8), (1024, 8)])
def test_a1_warps_follow_the_queries(l, warps):
    from fpqvar_tpu_torch.ops import packed_attention as PA

    assert PA.warps_for(l) == warps


def test_a1_takes_cache_views_and_tp_head_slices():
    """The operands as generation hands them: rows ``[0, end)`` of a
    block's cache leaves (a strided view), and under a tp mesh a q of
    this rank's heads cut from all of them."""
    from fpqvar_tpu_torch.ops import packed_attention as PA

    ops = _a1_operands(9, 5, torch.bfloat16, headroom=7)
    assert not ops[1].is_contiguous()
    PA.check_operands(*ops)
    q = torch.randn((4, 9, 6, 64), dtype=torch.bfloat16)[:, :, 3:]
    PA.check_operands(q, *ops[1:])
    PA.check_operands(ops[0].float(), *ops[1:])


def _bad_operands(case):
    """A1 operands broken one way (``case``), from good ones."""
    q, kc, ks, vc, vs = _a1_operands(9, 5, torch.bfloat16, headroom=3)
    kw = {}
    if case == "attn_bias":
        kw["attn_bias"] = torch.zeros((1, 1, 9, 14))
    elif case == "head_dim":
        q, kc, vc = q[..., :32], kc[..., :32], vc[..., :32]
    elif case == "float16":
        q = q.to(torch.float16)
    elif case == "codes_dtype":
        kc = kc.to(torch.int16)
    elif case == "scales_dtype":
        vs = vs.to(torch.bfloat16)
    elif case == "shapes":
        vc = vc[:, :, :-1]
    elif case == "q_layout":
        q = q.transpose(-1, -2).contiguous().transpose(-1, -2)
    elif case == "codes_layout":
        kc, vc = kc.transpose(1, 2), vc.transpose(1, 2)
        kc, vc = kc.contiguous().transpose(1, 2), vc.contiguous().transpose(
            1, 2)
    elif case == "codes_strides_differ":
        vc = vc.contiguous()
    elif case == "scales_layout":
        ks = ks.transpose(0, 1).contiguous().transpose(0, 1)
    elif case == "grad":
        q = q.float().requires_grad_()
    return (q, kc, ks, vc, vs), kw


@pytest.mark.parametrize("case", [
    "attn_bias", "head_dim", "float16", "codes_dtype", "scales_dtype",
    "shapes", "q_layout", "codes_layout", "codes_strides_differ",
    "scales_layout", "grad"])
def test_a1_refuses_what_the_kernel_does_not_take(case):
    """Each operand the kernel would misread raises before a launch (on a
    card ``packed_attention`` runs these checks; nothing falls back)."""
    from fpqvar_tpu_torch.ops import packed_attention as PA

    ops, kw = _bad_operands(case)
    with pytest.raises((ValueError, TypeError, RuntimeError)):
        PA.check_operands(*ops, **kw)
