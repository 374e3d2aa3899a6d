"""Plain PyTorch reference of a VAR class-to-image generator under an
FPQVAR recipe, teacher-forced on given tokens.

It takes the raw seeded weights (``benchmark/weights.py``), works out the
recipe's transform itself (GALT fold, 128-wide block rotation, weight
quantization) and runs all L tokens of a row at once under the
block-causal mask by scale, in the dtypes the configuration states:
activations, weights and the residual stream in bfloat16, matmuls
accumulating in float32, attention scores, softmax and the head in
float32, the VQVAE in float32.  Its pieces: the blocks' input from the
tokens (:meth:`Reference.inputs`: embeddings and the residual pyramid),
one block (:meth:`Reference.block`), the head with classifier-free
guidance (:meth:`Reference.head`) and the VQVAE decode
(:meth:`Reference.images`), so that each can start from the program's
own state.

With ``control=True`` it computes in the nearest precision below the
stated one: every bfloat16 operand of a linear and of attention rounded to
float8 e4m3, and the float32 matmuls and convolutions in TF32.

Imports nothing of the program under test.
"""
from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import quant as Q

BF16 = torch.bfloat16


@contextlib.contextmanager
def tf32(on: bool):
    """cuBLAS matmuls and cuDNN convolutions in TF32 (``on``) or float32
    inside the block; the flags are restored after it."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def scale_sizes(patch_nums):
    """(pn, tokens before the scale, pn * pn) of each scale."""
    out, cur = [], 0
    for pn in patch_nums:
        out.append((pn, cur, pn * pn))
        cur += pn * pn
    return out


def phi_index(si: int, n: int, share: int) -> int:
    """Which of the ``share`` partly shared phi convs scale ``si`` of ``n``
    uses: the nearest of ``share`` evenly placed ticks."""
    at = si / (n - 1)
    if share == 4:
        ticks = np.linspace(1 / 3 / share, 1 - 1 / 3 / share, share)
    else:
        ticks = np.linspace(1 / 2 / share, 1 - 1 / 2 / share, share)
    return int(np.argmin(np.abs(ticks - at)))


class Reference:
    """One configuration (``spec``: the configuration file's dict) on the
    raw weights ``raw`` = (VAR tree, (s_qkv, s_fc1), VQVAE tree)."""

    def __init__(self, spec: dict, raw, control: bool = False):
        self.m, self.v = spec["model"], spec["vae"]
        self.r, self.smp = spec["recipe"], spec["sampling"]
        self.var, galt, self.vae = raw
        self.galt = tuple(g.float() for g in galt)
        self.control = control
        self.width = self.m["embed_dim"]
        self.heads = self.m["num_heads"]
        self.hd = self.width // self.heads
        self.scales = scale_sizes(self.m["patch_nums"])
        self.L = sum(s[2] for s in self.scales)
        self._check_recipe()
        dev = self.var["class_emb"].device
        self.rot = None
        if self.r["rotate"]:
            self.rot = Q.hadamard_block(self.r["rotation_block"],
                                        self.r["rotation_seed"]).float().to(
                                            dev)

    def _check_recipe(self):
        r = self.r
        if not (r["enabled"] and r["block_rotate"] and r["transform"]
                and r["backend"] in ("fake", "int8")):
            raise ValueError("the reference runs the rotated, GALT-folded "
                             "fake and int8 recipes only")
        if r["backend"] == "fake" and not (
                r["weight_quant"] == r["act_quant"] == "per_group"):
            raise ValueError("fake recipes: per-group weights and acts")
        if r["backend"] == "int8" and not (
                r["weight_quant"] == "per_channel"
                and r["act_quant"] == "per_token"):
            raise ValueError("int8 recipes: per-channel weights, per-token "
                             "acts")
        if r["kv_backend"] == "fake" and r["kv_bit"] not in (0, 6):
            raise ValueError("fake KV: fp6 only")

    # ------------------------------------------------------------------
    # the recipe's pieces
    def _lp(self, t: torch.Tensor) -> torch.Tensor:
        """A bfloat16 operand, or under the control its fp8 rounding."""
        return Q.to_fp8(t) if self.control else t

    def _weight(self, key: str, i: int) -> torch.Tensor:
        """Block ``i``'s ``key`` weight after the transform: bfloat16
        fake-quantized values (fake backend) or float32 per-channel code
        values (int8 backend)."""
        w = self.var["blocks"][key][i].float()
        if key in ("mat_qkv_w", "fc1_w"):
            s = self.galt[0 if key == "mat_qkv_w" else 1][i]
            w = w / s[None, :]
            n = self.rot.shape[0]
            o, k = w.shape
            with tf32(False):
                w = (w.reshape(o, k // n, n) @ self.rot).reshape(o, k)
        fmt, g = self.r["weight_format"], self.r["group_size"]
        if self.r["backend"] == "fake":
            return Q.fake_quant(w, Q.GRIDS[fmt], g).to(BF16)
        return Q.quant_f32(w, fmt, w.shape[-1])

    def _act(self, kind: str, x: torch.Tensor) -> torch.Tensor:
        """The activation quantizer of a linear's input (bfloat16 in)."""
        r = self.r
        fmt = r["fc2_format"] if kind == "fc2" else r["act_format"]
        x = self._lp(x)
        if r["backend"] == "int8":
            return Q.quant_f32(x, fmt, x.shape[-1])
        if fmt in Q.DUAL_GRIDS:
            return Q.fake_quant_dual(x, fmt, r["group_size"])
        return Q.fake_quant(x, Q.GRIDS[fmt], r["group_size"])

    def _linear(self, kind, x, w, b=None):
        """A quantized block linear -> bfloat16."""
        xq = self._act(kind, x)
        if self.r["backend"] == "int8":
            with tf32(False):
                y = (xq @ w.T).to(BF16)
        else:
            y = xq @ self._lp(w).T
        return y if b is None else y + b.to(BF16)

    def _plain_linear(self, x, p):
        """An unquantized linear in ``x``'s dtype."""
        w = p["w"].to(x.dtype)
        if x.dtype == BF16:
            return x @ self._lp(w).T + p["b"].to(BF16)
        with tf32(self.control):
            return x @ w.T + p["b"].to(x.dtype)

    def _kv(self, t: torch.Tensor):
        """The KV cache's rounding of keys or values ``[B, L, H, c]``:
        (values in bfloat16, or for value codes (codes, scales))."""
        r = self.r
        if not r["kv_bit"]:
            return t
        if r["kv_backend"] == "fake":
            return Q.fake_quant(t, Q.E2M3, self.hd)
        return Q.value_codes(t, "fp_e2", 2, self.hd)

    # ------------------------------------------------------------------
    def _ln(self, x: torch.Tensor, eps: float) -> torch.Tensor:
        xf = x.float()
        mu = xf.mean(dim=-1, keepdim=True)
        var = (xf - mu).square().mean(dim=-1, keepdim=True)
        return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype)

    def _l2(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        n = torch.linalg.vector_norm(xf, dim=-1, keepdim=True)
        return (xf / n.clamp_min(1e-12)).to(x.dtype)

    def _rotate(self, x: torch.Tensor) -> torch.Tensor:
        n = self.rot.shape[0]
        xb = x.reshape(x.shape[:-1] + (x.shape[-1] // n, n))
        return (xb @ self.rot.to(x.dtype)).reshape(x.shape)

    def _mask(self, device) -> torch.Tensor:
        lvl = torch.cat([torch.full((l,), i, device=device)
                         for i, (_, _, l) in enumerate(self.scales)])
        bias = torch.zeros((self.L, self.L), device=device)
        return bias.masked_fill(lvl[None, :] > lvl[:, None], float("-inf"))

    def _attention(self, q, k, v, mask):
        """q, k, v ``[B, L, H, c]`` bfloat16 -> ``[B, L, H*c]``, one
        sequence and a few heads at a time."""
        b, L, h, c = q.shape
        packed = self.r["kv_backend"] == "packed" and self.r["kv_bit"]
        if packed:
            (kc, ks), (vc, vs) = self._kv(k), self._kv(v)
        else:
            k, v = self._lp(self._kv(k)), self._lp(self._kv(v))
        q = self._lp(q)
        out = torch.empty((b, L, h, c), dtype=BF16, device=q.device)
        hc = max(1, min(h, (1 << 28) // (L * L)))
        with tf32(self.control):
            for i in range(b):
                for h0 in range(0, h, hc):
                    hs = slice(h0, h0 + hc)
                    qi = q[i, :, hs].transpose(0, 1).float()    # [hc, L, c]
                    if packed:
                        kci = kc[i, :, hs].transpose(0, 1)
                        sc = (qi @ kci.transpose(-1, -2)) * ks[
                            i, :, hs, 0].transpose(0, 1)[:, None, :]
                        p = torch.softmax(sc + mask, dim=-1) * vs[
                            i, :, hs, 0].transpose(0, 1)[:, None, :]
                        o = self._lp(p.to(BF16)) @ vc[i, :, hs].transpose(
                            0, 1).to(BF16)
                    else:
                        ki = k[i, :, hs].transpose(0, 1).float()
                        sc = qi @ ki.transpose(-1, -2)
                        p = torch.softmax(sc + mask, dim=-1).to(BF16)
                        o = self._lp(p) @ v[i, :, hs].transpose(0, 1)
                    out[i, :, hs] = o.transpose(0, 1)
        return out.reshape(b, L, h * c)

    def _block(self, i, x, mod, mask):
        bp = self.var["blocks"]
        eps = self.m["norm_eps"]
        g1, g2, s1, s2, sh1, sh2 = mod
        b, L, c = x.shape
        x1 = self._ln(x, eps) * (1.0 + s1) + sh1
        x1 = self._rotate(x1 * self.galt[0][i].to(BF16))
        qkv = self._linear("mat_qkv", x1, self._weight("mat_qkv_w", i))
        bias = torch.cat([bp["q_bias"][i], torch.zeros_like(bp["q_bias"][i]),
                          bp["v_bias"][i]])
        qkv = (qkv + bias.to(BF16)).reshape(b, L, 3, self.heads, self.hd)
        q, k, v = qkv.unbind(2)
        sm = torch.exp(bp["scale_mul"][i].reshape(1, 1, self.heads, 1)
                       .float().clamp_max(math.log(100.0)))
        q = self._l2(q) * sm.to(BF16)
        k = self._l2(k)
        o = self._attention(q, k, v, mask)
        o = self._linear("proj", o, self._weight("proj_w", i),
                         bp["proj_b"][i])
        x = x + (o * g1).to(BF16)
        x2 = self._ln(x, eps) * (1.0 + s2) + sh2
        x2 = self._rotate(x2 * self.galt[1][i].to(BF16))
        h = F.gelu(self._linear("fc1", x2, self._weight("fc1_w", i),
                                bp["fc1_b"][i]), approximate="tanh")
        o = self._linear("fc2", h, self._weight("fc2_w", i), bp["fc2_b"][i])
        return x + (o * g2).to(BF16)

    def _mods(self, cond):
        """Per-block AdaLN modulations ``[depth, 6, B, 1, C]``."""
        d, c, b = self.m["depth"], self.width, cond.shape[0]
        act = F.silu(cond)
        if self.m["shared_aln"]:
            gss = self._plain_linear(act, self.var["shared_ada_lin"])
            mod = self.var["blocks"]["ada_gss"][:, None] + gss.reshape(
                b, 6, c)[None]
            return mod.permute(0, 2, 1, 3)[:, :, :, None, :]
        al = self.var["blocks"]["ada_lin"]
        out = []
        for i in range(d):
            y = act @ self._lp(al["w"][i].to(BF16)).T + al["b"][i].to(BF16)
            out.append(y.reshape(b, 6, c).permute(1, 0, 2)[:, :, None, :])
        return torch.stack(out)

    # ------------------------------------------------------------------
    def pyramid(self, tokens: torch.Tensor):
        """The residual pyramid of ``tokens`` ``[R, L]``: (the final
        ``f_hat`` ``[R, Cvae, hw, hw]`` float32, the next-scale inputs
        ``[R, L - first_l, Cvae]`` float32)."""
        v, q = self.v, self.vae["quantize"]
        emb = q["embedding"].float()
        r = tokens.shape[0]
        cz = v["z_channels"]
        hw = self.m["patch_nums"][-1]
        n = len(self.scales)
        f_hat = torch.zeros((r, cz, hw, hw), device=tokens.device)
        nxt = []
        with tf32(False):
            for si, (pn, cur, l) in enumerate(self.scales):
                h = emb[tokens[:, cur:cur + l]].transpose(1, 2).reshape(
                    r, cz, pn, pn)
                phi = q["phi"][phi_index(si, n, v["share_quant_resi"])]
                rr = abs(v["quant_resi"])
                if si != n - 1:
                    h = F.interpolate(h, size=(hw, hw), mode="bicubic",
                                      align_corners=False)
                h = h * (1.0 - rr) + F.conv2d(h, phi["w"].float(),
                                              phi["b"].float(),
                                              padding=1) * rr
                f_hat = f_hat + h
                if si != n - 1:
                    pnn = self.m["patch_nums"][si + 1]
                    down = F.interpolate(f_hat, size=(pnn, pnn), mode="area")
                    nxt.append(down.reshape(r, cz, -1).transpose(1, 2))
        return f_hat, torch.cat(nxt, dim=1)

    @torch.inference_mode()
    def inputs(self, labels: torch.Tensor, tokens: torch.Tensor) -> dict:
        """What the blocks of rows ``labels`` (cond rows, then the same
        rows unconditional) start from, teacher-forced on ``tokens``
        ``[R, L]``: ``x`` ``[2R, L, C]``, the guidance rows' class
        embeddings ``cond``, the AdaLN ``mods``, the attention ``mask``, and
        the final ``f_hat``."""
        p = self.var
        dev = labels.device
        f_hat, nxt = self.pyramid(tokens)
        uncond = torch.full_like(labels, self.m["num_classes"])
        cond = p["class_emb"][torch.cat([labels, uncond])].to(BF16)
        lvl = torch.cat([torch.full((l,), i, device=dev, dtype=torch.long)
                         for i, (_, _, l) in enumerate(self.scales)])
        lvl_pos = (p["lvl_embed"][lvl][None] + p["pos_1LC"]).to(BF16)
        first_l = self.scales[0][2]
        first = cond[:, None, :] + p["pos_start"].to(BF16) + lvl_pos[
            :, :first_l]
        with tf32(self.control):
            tok = (nxt @ p["word_embed"]["w"].float().T
                   + p["word_embed"]["b"].float()).to(BF16)
        tok = torch.cat([tok, tok]) + lvl_pos[:, first_l:]
        return {"x": torch.cat([first, tok], dim=1), "cond": cond,
                "mods": self._mods(cond), "mask": self._mask(dev),
                "f_hat": f_hat}

    @torch.inference_mode()
    def block(self, i: int, x: torch.Tensor, st: dict) -> torch.Tensor:
        """Block ``i`` on all tokens of ``x`` ``[2R, L, C]`` bfloat16 under
        the block-causal mask (``st`` from :meth:`inputs`)."""
        return self._block(i, x, st["mods"][i], st["mask"])

    @torch.inference_mode()
    def head_mod(self, cond: torch.Tensor) -> torch.Tensor:
        """The head's AdaLN scale and shift ``[2R, 2C]`` bfloat16."""
        return self._plain_linear(F.silu(cond), self.var["head_nm"])

    @torch.inference_mode()
    def head(self, x: torch.Tensor, hn: torch.Tensor) -> torch.Tensor:
        """The guided logits ``[R, L, V]`` float32 of the last block's
        output ``x`` ``[2R, L, C]`` under the head's AdaLN scale and shift
        ``hn`` (:meth:`head_mod`): the head's linear, then each scale's
        classifier-free guidance."""
        p = self.var
        r = x.shape[0] // 2
        sc, sh = hn.reshape(2 * r, 1, 2, self.width).unbind(2)
        h = self._ln(x.float(), self.m["norm_eps"]) * (1.0 + sc) + sh
        logit = self._plain_linear(h, p["head"])
        out = torch.empty((r, self.L, logit.shape[-1]), device=x.device)
        n = len(self.scales)
        for si, (_, cur, l) in enumerate(self.scales):
            t = self.smp["cfg"] * si / (n - 1)
            seg = slice(cur, cur + l)
            out[:, seg] = (1.0 + t) * logit[:r, seg] - t * logit[r:, seg]
        return out

    # ------------------------------------------------------------------
    @torch.inference_mode()
    def images(self, f_hat: torch.Tensor) -> torch.Tensor:
        """VQVAE decode of ``f_hat`` -> images in [0, 1] float32."""
        with tf32(self.control):
            z = _conv(f_hat, self.vae["post_quant_conv"])
            return (torch.clamp(_decoder(self.vae["decoder"], self.v, z),
                                -1.0, 1.0) + 1.0) * 0.5


# ---------------------------------------------------------------------------
# VQVAE decoder
# ---------------------------------------------------------------------------

def _conv(x, p, stride=1, padding=1):
    return F.conv2d(x, p["w"].float(), p["b"].float(), stride=stride,
                    padding=padding)


def _gn(x, p):
    return F.group_norm(x, min(32, x.shape[1]), p["w"].float(),
                        p["b"].float(), eps=1e-6)


def _swish(x):
    return x * torch.sigmoid(x)


def _resnet(x, p):
    h = _conv(_swish(_gn(x, p["norm1"])), p["conv1"])
    h = _conv(_swish(_gn(h, p["norm2"])), p["conv2"])
    if "nin_shortcut" in p:
        x = _conv(x, p["nin_shortcut"], padding=0)
    return x + h


def _attn(x, p):
    b, c, hh, ww = x.shape
    qkv = _conv(_gn(x, p["norm"]), p["qkv"], padding=0)
    q, k, v = torch.split(qkv.reshape(b, 3 * c, hh * ww), c, dim=1)
    att = torch.softmax(torch.einsum("bci,bcj->bij", q, k) * c ** -0.5, dim=2)
    out = torch.einsum("bci,bij->bcj", v, att).reshape(b, c, hh, ww)
    return x + _conv(out, p["proj_out"], padding=0)


def _decoder(p, v: dict, z):
    h = _conv(z, p["conv_in"])
    h = _resnet(h, p["mid"]["block_1"])
    h = _attn(h, p["mid"]["attn_1"])
    h = _resnet(h, p["mid"]["block_2"])
    for i in reversed(range(len(v["ch_mult"]))):
        level = p["up"][i]
        for j, blk in enumerate(level["block"]):
            h = _resnet(h, blk)
            if level["attn"]:
                h = _attn(h, level["attn"][j])
        if i != 0:
            h = _conv(F.interpolate(h, scale_factor=2, mode="nearest"),
                      level["upsample"])
    return _conv(_swish(_gn(h, p["norm_out"])), p["conv_out"])
