"""MLP variational autoencoder (PyTorch port of
``paddle_tpu/models/vae.py``; ref: v1_api_demo/vae/vae_conf.py): encoder
to (mu, logvar), a reparameterised sample, decoder, the ELBO loss.  The
noise is drawn inside the step: ``jax.random.normal`` of the op's key,
``ctx.rng_key(tag)`` (``ops/random.py``), so a warmed step's replay at
step s draws the eager step's noise at s.  The ELBO is written with the
Variable ``+`` and ``-``, as the reference's is."""
from __future__ import annotations

import torch

from .. import layers
from ..layers.helper import LayerHelper
from ..ops import random as jrandom


def build(x, img_dim: int = 784, hidden: int = 256, latent: int = 32):
    """x: [N, img_dim] in [0, 1].  Returns (elbo_loss, recon, mu,
    logvar)."""
    h = layers.fc(x, hidden, act="relu")
    h = layers.fc(h, hidden, act="relu")
    mu = layers.fc(h, latent)
    logvar = layers.fc(h, latent)

    # z = mu + exp(logvar / 2) * eps  (the reparameterisation)
    helper = LayerHelper("reparameterize")
    tag = helper.main_program.next_rng_tag()

    def fn(ctx, m, lv, tag):
        if m.device.type == "meta":
            return torch.empty_like(m)
        eps = jrandom.normal(ctx.rng_key(tag), tuple(m.shape), m.dtype,
                             m.device)
        return m + torch.exp(0.5 * lv) * eps

    z = helper.append_op(fn, {"Mu": [mu], "LogVar": [logvar]},
                         attrs={"tag": tag})

    d = layers.fc(z, hidden, act="relu")
    d = layers.fc(d, hidden, act="relu")
    recon_logits = layers.fc(d, img_dim)
    recon = layers.sigmoid(recon_logits)

    # ELBO: the bernoulli reconstruction NLL + KL(q(z|x) || N(0, I))
    bce = layers.reduce_sum(
        layers.sigmoid_cross_entropy_with_logits(recon_logits, x), dim=1)
    kl = layers.scale(
        layers.reduce_sum(
            layers.exp(logvar) + layers.square(mu) - logvar, dim=1)
        - float(latent), scale=0.5)
    loss = layers.mean(bce + kl)
    return loss, recon, mu, logvar
