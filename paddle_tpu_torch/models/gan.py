"""MLP GAN (PyTorch port of ``paddle_tpu/models/gan.py``; ref:
v1_api_demo/gan/gan_conf.py, trained alternately by gan_trainer.py).

Two Programs share one scope: the parameters are bound by name
(``ParamAttr``), and each optimizer updates only its side's
``parameter_list``, so D's step treats G as a frozen sampler and the other
way round.  The losses are written with the Variable ``+``, as the
reference's are.

Warmed, each program is its own signature with its own static state
buffers; a replay of one copies in the state the other's replay left in
the scope (``Executor._replay``), so every D/G alternation copies the
parameters both programs read across, twice."""
from __future__ import annotations

from .. import layers, optimizer
from ..core.program import Program, program_guard
from ..param_attr import ParamAttr


def _fc(x, size, act, name):
    return layers.fc(x, size, act=act,
                     param_attr=ParamAttr(name=f"{name}_w"),
                     bias_attr=ParamAttr(name=f"{name}_b"))


def generator(z, img_dim: int = 784, hidden: int = 256):
    h = _fc(z, hidden, "relu", "gan_g1")
    h = _fc(h, hidden, "relu", "gan_g2")
    return _fc(h, img_dim, "tanh", "gan_g3")


def discriminator(x, hidden: int = 256):
    h = _fc(x, hidden, "leaky_relu", "gan_d1")
    h = _fc(h, hidden, "leaky_relu", "gan_d2")
    return _fc(h, 1, None, "gan_d3")


G_PARAMS = [f"gan_g{i}_{s}" for i in range(1, 4) for s in ("w", "b")]
D_PARAMS = [f"gan_d{i}_{s}" for i in range(1, 4) for s in ("w", "b")]


def build(img_dim: int = 784, z_dim: int = 100, hidden: int = 256,
          lr: float = 2e-4):
    """Returns a dict with the two (program, startup, loss) triples and G's
    sample ``fake``.  Run d_startup, then g_startup (later inits win for
    shared names), then alternate runs of d_program and g_program on one
    scope."""
    d_program, d_startup = Program(), Program()
    g_program, g_startup = Program(), Program()

    with program_guard(d_program, d_startup):
        img = layers.data("img", [img_dim])
        z = layers.data("z", [z_dim])
        fake = generator(z, img_dim, hidden)
        logit_real = discriminator(img, hidden)
        logit_fake = discriminator(fake, hidden)
        ones = layers.fill_constant_batch_size_like(logit_real, [1, 1],
                                                    "float32", 1.0)
        zeros = layers.fill_constant_batch_size_like(logit_fake, [1, 1],
                                                     "float32", 0.0)
        d_loss = layers.mean(
            layers.sigmoid_cross_entropy_with_logits(logit_real, ones)
            + layers.sigmoid_cross_entropy_with_logits(logit_fake, zeros))
        optimizer.Adam(lr, beta1=0.5).minimize(d_loss,
                                               parameter_list=D_PARAMS)

    with program_guard(g_program, g_startup):
        z2 = layers.data("z", [z_dim])
        fake2 = generator(z2, img_dim, hidden)
        logit = discriminator(fake2, hidden)
        ones2 = layers.fill_constant_batch_size_like(logit, [1, 1],
                                                     "float32", 1.0)
        g_loss = layers.mean(
            layers.sigmoid_cross_entropy_with_logits(logit, ones2))
        optimizer.Adam(lr, beta1=0.5).minimize(g_loss,
                                               parameter_list=G_PARAMS)

    return {"d_program": d_program, "d_startup": d_startup, "d_loss": d_loss,
            "g_program": g_program, "g_startup": g_startup, "g_loss": g_loss,
            "fake": fake2}

