"""Calibration activation capture.

The JAX package's ``quantize/calibration.py``: one generation run returns,
per scale step, the stacked per-block inputs of the four quantized layer
kinds, plus the SiLU'd class condition.  Artifacts are stored as one npz
per (layer kind, block, step), the layout the GALT trainer and the format
search read, and the JAX package's file layout, so a store that one
package writes the other reads.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from fpqvar_tpu_torch.config import GenerateConfig, VARConfig
from fpqvar_tpu_torch.models import var as V
from fpqvar_tpu_torch.models import vqvae as vq
from fpqvar_tpu_torch.models.sampling import sample_with_top_k_top_p

LAYER_KINDS = ("mat_qkv", "proj", "fc1", "fc2")


@torch.inference_mode()
def capture_generation(
    params,
    vae_params,
    cfg: VARConfig,
    label_B,
    generator: Optional[torch.Generator] = None,
    gen: GenerateConfig = GenerateConfig(),
    qrt=None,
) -> List[Dict[str, np.ndarray]]:
    """Class-conditional generation capturing activation taps, on the
    params' device: JAX's eager loop (a float32 KV cache, packed under
    ``qrt``'s KV codec; ``run_blocks(capture=True)``; CFG; sampling from
    ``generator``).  Returns a list over scale steps; each element maps
    layer kind -> ``[depth, 2B, l_si, C]`` float32 numpy (fc2 ``4C``
    wide)."""
    device = params["class_emb"].device
    label_B = torch.as_tensor(label_B, dtype=torch.long, device=device)
    b = label_B.shape[0]
    cond_BD, mod, lvl_pos, x = V.prepare_generation(params, cfg, label_B)
    cache = V.init_kv_cache(cfg, 2 * b, torch.float32, device,
                            qrt.kv_codec if qrt is not None else None)
    hw = cfg.patch_nums[-1]
    f_hat = torch.zeros((b, cfg.vae.z_channels, hw, hw), dtype=torch.float32,
                        device=device)
    vae_q = vae_params["quantize"]

    all_taps: List[Dict[str, np.ndarray]] = []
    for st in V.GenStatics.all_steps(cfg):
        x_out, taps = V.run_blocks(params, cfg, qrt, x, mod, cache, st.cur,
                                   capture=True)
        all_taps.append({k: v.to(torch.float32).cpu().numpy()
                         for k, v in taps.items()})

        logits = V.head_logits(params, cfg, x_out.to(torch.float32), cond_BD)
        t = gen.cfg * (st.si / (cfg.num_scales - 1))
        logits = (1.0 + t) * logits[:b] - t * logits[b:]
        idx_Bl = sample_with_top_k_top_p(logits, gen.top_k, gen.top_p,
                                         generator)
        h = vq.embed_idx(vae_q, idx_Bl).transpose(1, 2).reshape(
            b, cfg.vae.z_channels, st.pn, st.pn).to(torch.float32)
        f_hat, next_raw = vq.get_next_autoregressive_input(
            vae_q, cfg.vae, st.si, f_hat, h)
        if st.si == cfg.num_scales - 1:
            break
        pn_next = cfg.patch_nums[st.si + 1]
        nxt = next_raw.reshape(b, cfg.vae.z_channels, -1).transpose(1, 2)
        we = params["word_embed"]
        nxt = V.linear(nxt, we["w"], we["b"])
        cur_end = st.cur + st.l
        nxt = nxt + lvl_pos[:, cur_end: cur_end + pn_next * pn_next]
        x = torch.cat([nxt, nxt], dim=0)
    return all_taps


@torch.inference_mode()
def capture_condition(params, cfg: VARConfig, labels) -> np.ndarray:
    """SiLU(class embedding) per label, float32 numpy ``[N, C]``: the
    input of ``ada_lin``."""
    emb = params["class_emb"]
    idx = torch.as_tensor(np.asarray(labels), dtype=torch.long,
                          device=emb.device)
    return F.silu(emb[idx]).to(torch.float32).cpu().numpy()


class CalibrationStore:
    """npz-file artifact store keyed by (kind, block, step)."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def _path(self, kind: str, block: int, step: int) -> str:
        return os.path.join(self.root, f"{kind}_block{block}_step{step}.npz")

    def append_run(self, taps_per_step: List[Dict[str, np.ndarray]]) -> None:
        """Merge a capture run into the store (concatenating over batch)."""
        for step, taps in enumerate(taps_per_step):
            for kind, arr in taps.items():
                arr = np.asarray(arr, np.float32)
                for blk in range(arr.shape[0]):
                    p = self._path(kind, blk, step)
                    new = arr[blk]
                    if os.path.exists(p):
                        new = np.concatenate([self.load(kind, blk, step), new],
                                             axis=0)
                    np.savez_compressed(p, x=new)

    def load(self, kind: str, block: int, step: int) -> np.ndarray:
        with np.load(self._path(kind, block, step)) as f:
            return f["x"]

    def steps(self, kind: str, block: int) -> int:
        s = 0
        while os.path.exists(self._path(kind, block, s)):
            s += 1
        return s
