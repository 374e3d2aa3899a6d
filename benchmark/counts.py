"""The yardstick's arithmetic: the chip's peaks, a generation's model FLOPs
from a configuration's shapes, the bound of the int8 GEMM kernels, and the
names of the program's kernels as the device trace shows them.

Peaks: NVIDIA's data sheet for the H100 SXM (dense, at 700 W).  A bound
is ``max(bytes / HBM, operations / peak)`` with each input byte read
once and each output byte written once.
"""
from __future__ import annotations

PEAK_BF16 = 989e12          # FLOP/s
PEAK_INT8 = 1979e12         # OP/s
HBM = 3.35e12               # bytes/s

#: program kernels by parts of their names in the device trace
KERNELS = {"K1": ("GroupFold",),
           "K2": ("rs_gemm_kernel", "packed_dequant_gemm_kernel"),
           "K3": ("Int8ChRescale",),
           "K4 (a)": ("fused_ch_quantize_kernel",),
           "K4 (b)": ("FusedChRescale",),
           "K5": ("NdGroupSum",),
           "Q1": ("fake_grid_kernel", "fake_dual_kernel"),
           "Q2": ("grid_codes_kernel", "dual_codes_kernel"),
           "Q3": ("fake_int_kernel",)}


def scale_steps(patch_nums):
    """(tokens of the scale, tokens attended to) of each scale."""
    out, end = [], 0
    for pn in patch_nums:
        end += pn * pn
        out.append((pn * pn, end))
    return out


def _conv(cout, cin, k, hw):
    return 2 * cout * cin * k * k * hw * hw


def decoder_flops(v: dict, hw_in: int) -> int:
    """FLOPs of one image's VQVAE decode from ``f_hat`` at ``hw_in``:
    every convolution and the attention products."""
    ch, mult, nres = v["ch"], v["ch_mult"], len(v["ch_mult"])
    cz, cmid = v["z_channels"], ch * mult[-1]
    f = _conv(cz, cz, 3, hw_in) + _conv(cmid, cz, 3, hw_in)

    def resnet(cin, cout, hw):
        n = _conv(cout, cin, 3, hw) + _conv(cout, cout, 3, hw)
        return n + (_conv(cout, cin, 1, hw) if cin != cout else 0)

    def attn(c, hw):
        return _conv(3 * c, c, 1, hw) + _conv(c, c, 1, hw) + 4 * c * hw ** 4

    hw = hw_in
    f += 2 * resnet(cmid, cmid, hw) + attn(cmid, hw)
    block_in = cmid
    for i in reversed(range(nres)):
        cout = ch * mult[i]
        for _ in range(v["num_res_blocks"] + 1):
            f += resnet(block_in, cout, hw)
            block_in = cout
            if i == nres - 1:
                f += attn(cout, hw)
        if i != 0:
            hw *= 2
            f += _conv(cout, cout, 3, hw)
    return f + _conv(3, block_in, 3, hw)


def block_linear_flops(m: dict) -> int:
    """FLOPs of the block linears for one image: both guidance rows, every
    token, every block (qkv 3C^2, proj C^2, fc1 and fc2 4C^2 each)."""
    c, d = m["embed_dim"], m["depth"]
    L = sum(p * p for p in m["patch_nums"])
    return 2 * 2 * L * d * 12 * c * c


def model_flops_per_image(spec: dict) -> int:
    """A generation's FLOPs for one image: the block linears, attention
    (q.k and p.v over the tokens each scale attends to), the AdaLN and
    head linears, the word embedding, the residual pyramid's phi convs and
    the VQVAE decode.  The same work whatever the recipe runs it with."""
    m, v = spec["model"], spec["vae"]
    c, d = m["embed_dim"], m["depth"]
    pns = m["patch_nums"]
    L = sum(p * p for p in pns)
    vocab, cz, hw = v["vocab_size"], v["z_channels"], pns[-1]
    f = block_linear_flops(m)
    f += 2 * d * sum(4 * c * l * end for l, end in scale_steps(pns))
    f += 2 * d * 2 * 6 * c * c if not m["shared_aln"] else 2 * 2 * 6 * c * c
    f += 2 * 2 * 2 * c * c + 2 * L * 2 * c * vocab
    f += 2 * (L - pns[0] ** 2) * cz * c
    f += len(pns) * _conv(cz, cz, 3, hw)
    return f + decoder_flops(v, hw)


def int8_gemm_bound_s(m: dict, batch: int) -> float:
    """The least time of one generation's per-channel int8 GEMMs at
    ``batch`` images: K4 (b) at qkv, proj and fc1 (int8 codes in, bf16
    out) and K3 twice at fc2 (the dual grid's halves, float32 out), each
    call ``max(bytes / HBM, 2MNK / int8 peak)``; codes one byte, scales
    four."""
    c, d = m["embed_dim"], m["depth"]
    total = 0.0
    for l, _ in scale_steps(m["patch_nums"]):
        rows = 2 * batch * l
        for n, k, out_bytes, calls in ((3 * c, c, 2, 1), (c, c, 2, 1),
                                       (4 * c, c, 2, 1), (c, 4 * c, 4, 2)):
            nbytes = rows * k + n * k + 4 * rows + 4 * n + out_bytes * rows * n
            t = max(nbytes / HBM, 2 * rows * n * k / PEAK_INT8)
            total += calls * t
    return d * total
