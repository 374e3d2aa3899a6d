"""Seeded random weights of a configuration, made on the device in a few
large calls, in the layout of a VAR checkpoint tree (block parameters
stacked along a leading depth axis, linears (out, in)).

The same seed gives the same tensors on the same device.  The benchmark
hands them to the program (which transforms them under its recipe) and,
once the measured window has closed, makes them again for the
reference.  The VAR tree is bfloat16, the VQVAE float32, the GALT
vectors float32 values that bfloat16 holds exactly.

Scales: linears 0.02 (residual outputs 0.02 / sqrt(2 depth)), biases
0.01, class embeddings 1 and the other embeddings sqrt(1 / 3C), AdaLN
linears 0.01 so that each block's gates are of order 0.1 and the logits
depend on every block; GALT vectors exp(0.25 z); VQVAE convs uniform in
+-1/sqrt(fan_in), codebook 0.5.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def stream_seed(seed: int, stream: int) -> int:
    """A 63-bit generator seed for one stream of draws of ``seed``."""
    words = np.random.SeedSequence([seed & 0xFFFFFFFFFFFFFFFF, stream])
    return int(words.generate_state(1, np.uint64)[0]) & 0x7FFFFFFFFFFFFFFF


class _Flat:
    """Leaves carved out of one buffer filled by one call."""

    def __init__(self):
        self.leaves = []

    def add(self, shape, scale, offset=0.0):
        self.leaves.append((tuple(shape), scale, offset))
        return len(self.leaves) - 1

    def fill(self, draw, dtype, device, gen):
        n = sum(math.prod(s) for s, _, _ in self.leaves)
        flat = draw(n, dtype=dtype, device=device, generator=gen)
        out, at = [], 0
        for shape, scale, offset in self.leaves:
            t = flat[at: at + math.prod(shape)].view(shape)
            at += math.prod(shape)
            if callable(scale):
                t.copy_(scale(t))
            else:
                t.mul_(scale)
                if offset:
                    t.add_(offset)
            out.append(t)
        return out


def _gen(device, seed, stream):
    g = torch.Generator(device=device)
    g.manual_seed(stream_seed(seed, stream))
    return g


def make_var(m: dict, vocab: int, cvae: int, seed: int, device):
    """(VAR tree in bfloat16, (s_qkv, s_fc1)) of the model dict ``m``."""
    d, c, h = m["depth"], m["embed_dim"], m["num_heads"]
    L = sum(p * p for p in m["patch_nums"])
    first_l = m["patch_nums"][0] ** 2
    res = 0.02 / math.sqrt(2 * d)
    big = _Flat()
    keys = ("mat_qkv_w", "proj_w", "fc1_w", "fc2_w")
    for shape, s in (((d, 3 * c, c), 0.02), ((d, c, c), res),
                     ((d, 4 * c, c), 0.02), ((d, c, 4 * c), res)):
        big.add(shape, s)
    small = _Flat()
    emb = math.sqrt(1.0 / c / 3.0)
    spec = {
        "q_bias": ((d, c), 0.01), "v_bias": ((d, c), 0.01),
        "proj_b": ((d, c), 0.01), "fc1_b": ((d, 4 * c), 0.01),
        "fc2_b": ((d, c), 0.01),
        "scale_mul": ((d, 1, h, 1, 1), 0.1, math.log(4.0)),
        "word_embed.w": ((c, cvae), 0.02), "word_embed.b": ((c,), 0.01),
        "class_emb": ((m["num_classes"] + 1, c), 1.0),
        "pos_start": ((1, first_l, c), emb), "pos_1LC": ((1, L, c), emb),
        "lvl_embed": ((len(m["patch_nums"]), c), emb),
        "head_nm.w": ((2 * c, c), 0.01), "head_nm.b": ((2 * c,), 0.01),
        "head.w": ((vocab, c), 0.02), "head.b": ((vocab,), 0.01),
    }
    if m["shared_aln"]:
        spec["ada_gss"] = ((d, 6, c), 1.0 / math.sqrt(c))
        spec["shared_ada_lin.w"] = ((6 * c, c), 0.01)
        spec["shared_ada_lin.b"] = ((6 * c,), 0.01)
    else:
        spec["ada_lin.w"] = ((d, 6 * c, c), 0.01)
        spec["ada_lin.b"] = ((d, 6 * c), 0.01)
    names = list(spec)
    for name in names:
        small.add(*spec[name])
    bf = torch.bfloat16
    w_big = big.fill(torch.randn, bf, device, _gen(device, seed, 1))
    w_small = dict(zip(names, small.fill(torch.randn, bf, device,
                                         _gen(device, seed, 2))))
    z = torch.randn((2, d, c), device=device, generator=_gen(device, seed, 3))
    galt = torch.exp(0.25 * z).to(bf).float()

    def lin(prefix):
        return {"w": w_small[prefix + ".w"], "b": w_small[prefix + ".b"]}

    ones = torch.ones((d, c), dtype=bf, device=device)
    blocks = dict(zip(keys, w_big))
    blocks.update({k: w_small[k] for k in ("q_bias", "v_bias", "proj_b",
                                           "fc1_b", "fc2_b", "scale_mul")})
    blocks["mat_qkv_s"], blocks["fc1_s"] = ones, ones.clone()
    tree = {"word_embed": lin("word_embed"), "class_emb": w_small["class_emb"],
            "pos_start": w_small["pos_start"], "pos_1LC": w_small["pos_1LC"],
            "lvl_embed": w_small["lvl_embed"], "blocks": blocks,
            "head_nm": lin("head_nm"), "head": lin("head")}
    if m["shared_aln"]:
        blocks["ada_gss"] = w_small["ada_gss"]
        tree["shared_ada_lin"] = lin("shared_ada_lin")
    else:
        blocks["ada_lin"] = lin("ada_lin")
    return tree, (galt[0], galt[1])


def make_vqvae(v: dict, seed: int, device):
    """The decoder side of a VQVAE tree in float32: ``decoder``,
    ``post_quant_conv`` and ``quantize`` (codebook and phi convs)."""
    flat = _Flat()

    def conv(o, i, k):
        bound = 1.0 / math.sqrt(i * k * k)

        def u(t):
            return (t * 2.0 - 1.0) * bound

        return {"w": flat.add((o, i, k, k), u), "b": flat.add((o,), u)}

    def gn(c):
        return {"w": ("ones", c), "b": ("zeros", c)}

    def resnet(cin, cout):
        p = {"norm1": gn(cin), "conv1": conv(cout, cin, 3),
             "norm2": gn(cout), "conv2": conv(cout, cout, 3)}
        if cin != cout:
            p["nin_shortcut"] = conv(cout, cin, 1)
        return p

    def attn(c):
        return {"norm": gn(c), "qkv": conv(3 * c, c, 1),
                "proj_out": conv(c, c, 1)}

    ch, mult, nres = v["ch"], v["ch_mult"], len(v["ch_mult"])
    cmid = ch * mult[-1]
    dec = {"conv_in": conv(cmid, v["z_channels"], 3),
           "mid": {"block_1": resnet(cmid, cmid), "attn_1": attn(cmid),
                   "block_2": resnet(cmid, cmid)}}
    up = [None] * nres
    block_in = cmid
    for i in reversed(range(nres)):
        cout = ch * mult[i]
        level = {"block": [], "attn": []}
        for _ in range(v["num_res_blocks"] + 1):
            level["block"].append(resnet(block_in, cout))
            block_in = cout
            if i == nres - 1:
                level["attn"].append(attn(cout))
        if i != 0:
            level["upsample"] = conv(cout, cout, 3)
        up[i] = level
    dec["up"] = up
    dec["norm_out"] = gn(block_in)
    dec["conv_out"] = conv(3, block_in, 3)
    cz = v["z_channels"]
    phi = [conv(cz, cz, 3) for _ in range(v["share_quant_resi"])]
    post = conv(cz, cz, 3)
    leaves = flat.fill(torch.rand, torch.float32, device,
                       _gen(device, seed, 4))
    embedding = torch.randn((v["vocab_size"], cz), device=device,
                            generator=_gen(device, seed, 5)) * 0.5

    def resolve(x):
        if isinstance(x, dict):
            return {k: resolve(y) for k, y in x.items()}
        if isinstance(x, list):
            return [resolve(y) for y in x]
        if isinstance(x, tuple) and x[0] in ("ones", "zeros"):
            return (torch.ones if x[0] == "ones" else torch.zeros)(
                x[1], device=device)
        return leaves[x]

    return {"decoder": resolve(dec), "post_quant_conv": resolve(post),
            "quantize": {"embedding": embedding, "phi": resolve(phi)}}


def make(spec: dict, seed: int, device):
    """(VAR tree, GALT vectors, VQVAE tree) of configuration ``spec``."""
    v = spec["vae"]
    var, galt = make_var(spec["model"], v["vocab_size"], v["z_channels"],
                         seed, device)
    return var, galt, make_vqvae(v, seed, device)
