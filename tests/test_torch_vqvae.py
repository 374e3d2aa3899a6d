"""The port's VQVAE decode side against the JAX package.

A seeded VQVAE tree in the JAX package's layout goes through the bridge;
the same seeded numpy inputs go through both ``decode`` and the
residual-pyramid step.  The resize matrices are built by the same numpy code and must be
equal; the float32 convolutions and matmuls sum in another order, so
decoded images (values in [-1, 1]) agree within 1e-5 and the pyramid
within 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fpqvar_tpu.config import VQVAEConfig as JVQVAEConfig
from fpqvar_tpu.config import var_tiny as jax_var_tiny
from fpqvar_tpu.models import vqvae as Jvq
from fpqvar_tpu.ops import resize as JR

from fpqvar_tpu_torch.config import PATCH_NUMS_256, VQVAEConfig, var_tiny
from fpqvar_tpu_torch.models import vqvae as vq
from fpqvar_tpu_torch.ops import resize as R
from fpqvar_tpu_torch.utils.bridge import to_torch
from torch_threads import one_torch_thread  # noqa: F401

_WIDE = dict(vocab_size=64, z_channels=8, ch=32, ch_mult=(1, 2, 2),
             num_res_blocks=2, patch_nums=(1, 2, 4))
CONFIGS = {
    "tiny": (jax_var_tiny().vae, var_tiny().vae),
    "three_levels": (JVQVAEConfig(**_WIDE), VQVAEConfig(**_WIDE)),
}


def _params(jcfg):
    """A VQVAE tree in the JAX package's layout (shapes from its
    ``init_vqvae_params``) with seeded numpy values: uniform
    +-1/sqrt(fan_in) convs, unit norms, N(0, 0.02) codebook.  (The JAX
    init itself costs 10-16 s per config on the CPU.)"""
    shapes = jax.eval_shape(
        lambda k: Jvq.init_vqvae_params(k, jcfg), jax.random.PRNGKey(3))
    rng = np.random.default_rng(3)

    def fill(path, leaf):
        names = [getattr(k, "key", getattr(k, "idx", None)) for k in path]
        if names[-1] == "embedding":
            v = rng.standard_normal(leaf.shape) * 0.02
        elif leaf.ndim == 1 and any(str(n).startswith("norm") for n in names):
            v = np.ones(leaf.shape) if names[-1] == "w" else np.zeros(leaf.shape)
        else:
            fan_in = int(np.prod(leaf.shape[1:])) if leaf.ndim == 4 else 1
            lim = 1.0 / np.sqrt(fan_in if leaf.ndim == 4 else leaf.shape[0])
            v = rng.uniform(-lim, lim, leaf.shape)
        return v.astype(np.float32)

    jp = jax.tree_util.tree_map_with_path(fill, shapes)
    return jp, to_torch(jp, "cpu")


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_decode_matches_jax(name):
    jcfg, cfg = CONFIGS[name]
    jp, tp = _params(jcfg)
    hw = cfg.patch_nums[-1]
    rng = np.random.default_rng(0)
    f_hat = rng.standard_normal((2, cfg.z_channels, hw, hw)).astype(np.float32)
    theirs = np.asarray(jax.jit(lambda p, f: Jvq.decode(p, jcfg, f))(
        jp, jnp.asarray(f_hat)))
    ours = vq.decode(tp, cfg, torch.from_numpy(f_hat)).numpy()
    side = hw * cfg.downsample
    assert ours.shape == (2, 3, side, side)
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=1e-5)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_residual_pyramid_matches_jax(name):
    jcfg, cfg = CONFIGS[name]
    jp, tp = _params(jcfg)
    pns = cfg.patch_nums
    rng = np.random.default_rng(1)
    f_hat = rng.standard_normal((2, cfg.z_channels, pns[-1], pns[-1])
                                ).astype(np.float32)
    for si, pn in enumerate(pns):
        h = rng.standard_normal((2, cfg.z_channels, pn, pn)).astype(np.float32)
        jf, jn = Jvq.get_next_autoregressive_input(
            jp["quantize"], jcfg, si, jnp.asarray(f_hat), jnp.asarray(h))
        tf, tn = vq.get_next_autoregressive_input(
            tp["quantize"], cfg, si, torch.from_numpy(f_hat.copy()),
            torch.from_numpy(h))
        np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=0,
                                   atol=1e-6)
        np.testing.assert_allclose(tn.numpy(), np.asarray(jn), rtol=0,
                                   atol=1e-6)
        f_hat = np.asarray(jf)


def test_embed_idx_and_phi_index():
    jp, tp = _params(jax_var_tiny().vae)
    idx = np.random.default_rng(2).integers(0, 64, (2, 9))
    np.testing.assert_array_equal(
        vq.embed_idx(tp["quantize"], torch.from_numpy(idx)).numpy(),
        np.asarray(Jvq.embed_idx(jp["quantize"], jnp.asarray(idx))))
    for sn, share in ((len(PATCH_NUMS_256), 4), (3, 4), (10, 2)):
        for si in range(sn):
            assert vq.phi_index(si, sn, share) == Jvq.phi_index(si, sn, share)


@pytest.mark.parametrize("n_in,n_out", [(1, 16), (2, 16), (3, 16), (13, 16),
                                        (16, 10), (16, 5), (16, 1), (4, 3)])
def test_resize_matrices_equal(n_in, n_out):
    np.testing.assert_array_equal(R.bicubic_matrix(n_in, n_out),
                                  JR.bicubic_matrix(n_in, n_out))
    np.testing.assert_array_equal(R.area_matrix(n_in, n_out),
                                  JR.area_matrix(n_in, n_out))
