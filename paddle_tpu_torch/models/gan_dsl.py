"""demo/gan in the layer DSL (``demo/gan/train.py``; the reference's
demo/gan/gan_trainer.py:251-265, two GradientMachines driven from
Python): two ``Topology``s trained in turn outside ``SGD.train``.

The generator ``z (8) -> fc g_h (32, relu) -> fc g_out (2)`` maps noise
to 2-D points; the discriminator ``pt (2) -> fc d_h (32, relu) -> fc
d_out (1, sigmoid)`` tells real points (a ring of radius 1, noise 0.05)
from generated ones.  Each step is the demo's pair of jitted steps as
functions of the parameter trees (``Topology.apply`` and the functional
``optim.Adam.init`` / ``update``, lr 2e-3, batch 64): first the
discriminator's loss ``-mean(log(D(real) + eps) + log(1 - D(G(z)) +
eps))``, then the generator's ``-mean(log(D(G(z')) + eps))``, each on
fresh ``z``.  The end check is the demo's: the mean radius of 256
generated points, near 1.  No kernel of the port's own is on this
path.

``python -m paddle_tpu_torch.models.gan_dsl [--steps N] [--device cpu]``
trains and prints the radius.
"""

import argparse

import numpy as np
import torch

from paddle_tpu_torch import device as _device
from paddle_tpu_torch import layers as L
from paddle_tpu_torch.optim import Adam
from paddle_tpu_torch.utils.tree import tree_leaves, tree_map, \
    value_and_grad

Z, H = 8, 32
BATCH = 64
LR = 2e-3
EPS = 1e-6
CHECK_POINTS = 256


def build():
    """(generator topology, discriminator topology, fake, d_out), with a
    fresh layer-name registry."""
    L.reset_names()
    z = L.data_layer("z", size=Z)
    g_h = L.fc_layer(z, size=H, act="relu", name="g_h")
    fake = L.fc_layer(g_h, size=2, act=None, name="g_out")
    pt = L.data_layer("pt", size=2)
    d_h = L.fc_layer(pt, size=H, act="relu", name="d_h")
    d_out = L.fc_layer(d_h, size=1, act="sigmoid", name="d_out")
    return L.Topology(fake), L.Topology(d_out), fake, d_out


def real_batch(rng, n=BATCH):
    """n points of the ring (the demo's draws from ``rng``)."""
    theta = rng.uniform(0, 2 * np.pi, n).astype(np.float32)
    r = 1.0 + 0.05 * rng.randn(n).astype(np.float32)
    return np.stack([r * np.cos(theta), r * np.sin(theta)], -1)


class Gan:
    """The demo's two networks, their Adam states and the two steps."""

    def __init__(self, g_params, d_params):
        self.g_topo, self.d_topo, _, _ = build()
        self.g_params, self.d_params = g_params, d_params
        self.g_opt, self.d_opt = Adam(learning_rate=LR), \
            Adam(learning_rate=LR)
        self.g_state = self.g_opt.init(g_params)
        self.d_state = self.d_opt.init(d_params)
        self.device = tree_leaves(g_params)[0].device

    def fake(self, gp, z):
        return self.g_topo.apply(gp, {"z": z}, mode="test")

    def d_score(self, dp, pts):
        return self.d_topo.apply(dp, {"pt": pts}, mode="test")

    def d_loss(self, dp, gp, z, real):
        fake = self.fake(gp, z)
        return -torch.mean(torch.log(self.d_score(dp, real) + EPS)
                           + torch.log(1 - self.d_score(dp, fake) + EPS))

    def g_loss(self, gp, dp, z):
        return -torch.mean(torch.log(self.d_score(dp, self.fake(gp, z))
                                     + EPS))

    def d_step(self, z, real):
        gp = tree_map(torch.Tensor.detach, self.g_params)
        loss, g = value_and_grad(lambda dp: self.d_loss(dp, gp, z, real),
                                 self.d_params)
        self.d_params, self.d_state = self.d_opt.update(g, self.d_state,
                                                        self.d_params)
        return loss

    def g_step(self, z):
        dp = tree_map(torch.Tensor.detach, self.d_params)
        loss, g = value_and_grad(lambda gp: self.g_loss(gp, dp, z),
                                 self.g_params)
        self.g_params, self.g_state = self.g_opt.update(g, self.g_state,
                                                        self.g_params)
        return loss

    def step(self, rng):
        """One demo step from the host ``rng``: the discriminator on
        (z, a real batch), then the generator on a fresh z.  Returns the
        two losses (device scalars)."""
        dev = self.device
        z = torch.as_tensor(rng.randn(BATCH, Z).astype(np.float32),
                            device=dev)
        real = torch.as_tensor(real_batch(rng), device=dev)
        dl = self.d_step(z, real)
        z = torch.as_tensor(rng.randn(BATCH, Z).astype(np.float32),
                            device=dev)
        return dl, self.g_step(z)

    def radii(self, rng, n=CHECK_POINTS):
        """The demo's end check: the radii of n generated points."""
        z = torch.as_tensor(rng.randn(n, Z).astype(np.float32),
                            device=self.device)
        with torch.no_grad():
            pts = self.fake(self.g_params, z).cpu().numpy()
        return np.sqrt((pts ** 2).sum(-1))


def init(seed=0, device=None):
    """A ``Gan`` from the port's own init (``Topology.init`` over a CPU
    generator seeded ``seed``; JAX's PRNGKey draws differ)."""
    dev = _device.resolve(device)
    g_topo, d_topo, _, _ = build()
    gen = torch.Generator().manual_seed(seed)
    return Gan(g_topo.init(gen, device=dev), d_topo.init(gen, device=dev))


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m paddle_tpu_torch.models."
                                      "gan_dsl")
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--log_period", type=int, default=100)
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    gan = init(device=args.device)
    rng = np.random.RandomState(0)
    for i in range(args.steps):
        dl, gl = gan.step(rng)
        if (i + 1) % args.log_period == 0:
            print(f"step {i + 1}: d_loss={float(dl):.4f} "
                  f"g_loss={float(gl):.4f}", flush=True)
    radii = gan.radii(rng)
    print(f"generated radius mean={radii.mean():.3f} (target 1.0) "
          f"std={radii.std():.3f}", flush=True)
    return radii


if __name__ == "__main__":
    main()
