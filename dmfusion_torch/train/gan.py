"""Stage-1 GAN training programs (the two-stage solver's GAN quartet).

Port of ``dmfusion/train/gan.py`` (reference solver/tostagesolver.py:62-178):
two generators (gen_P maps MS-shaped noise to a fake pseudo-PAN tile, gen_M
maps PAN-shaped noise to a fake MS tile) and two discriminators, with one
Adam(0.5, 0.999) over both generators and one over both discriminators.
Per batch of scene tiles (m, p) and two normal noise images (n_m, n_p):

  * discriminator step: MSE real/fake adversarial loss on both
    modalities, the fakes detached;
  * generator step against the *updated* discriminators: adversarial +
    l_cy * cycle L1 + l_id * identity L1 + l_ad * cross-reconstruction L1,
    halved.  The cycle, identity and cross terms compare with the noise,
    not with the tiles: the reference's semantics, kept.

The generator loss reuses the fakes of the discriminator step, with their
graph: dmfusion recomputes them inside its loss, but the generators have
not changed in between, so the values are the same and two generator
passes a step are saved.  The generator pass adds no gradient to the
discriminators (``backward(inputs=...)``), and each step sets every
``.grad`` to None before its backward.

Compute runs under bf16 autocast when ``precision.compute_dtype`` says so,
with no ``GradScaler``: dmfusion computes in straight bf16, and bf16 needs
no loss scaling.  The last conv of each net, the sigmoid and every loss
are float32.

One epoch is a Python loop over tile batches on the device.  Fake tiles
are kept only when something reads them (``collect``): 'all' fills a
device buffer of every step's fakes (the last epoch, whose fakes become
the full-scene msgan/pangan scenes), 'first' keeps the first batch's (the
sample grids), 'none' keeps the losses only.  The losses stay on the
device, one fetch an epoch by the caller.

Noise: dmfusion draws two normal images a step with ``jax.random.normal``;
the port draws them from its own ``torch.Generator`` on the run's device
(:func:`seeded_noise`).  ``GanPrograms(noise=...)`` takes any draw
``(m, p) -> (n_m, n_p)``, which is how the tests feed JAX's own draws.

Under a mesh (``parallel/mesh.py``; dmfusion shards the tile batch and its
noise over ``data``, ``dmfusion/train/gan.py:95-105``) every rank holds
the same (steps, B) tile batches, B a multiple of the ranks, starts from
rank 0's parameters, and runs the step on its contiguous equal shard of
each batch.  The noise is drawn for the whole batch on every rank, from
the same seeded draw, and the rank's rows are sliced from it, so the draws
advance as in one process.  The discriminators' gradients are averaged
over the ranks before their update (the generator step then sees the
updated discriminators), the generators' before theirs: with equal shards
the mean of the ranks' MSE and L1 means is the whole batch's.  On a
``data x model`` mesh the nets stay replicated, as dmfusion's two-stage
solver keeps them: the model peers of a data index run the same shard and
take the first peer's averaged gradients (``Mesh.sync_peers_``), so they
hold the same bits.  The returned losses are the ranks' mean, and the kept
fakes every rank's, in batch order.
"""

from __future__ import annotations

from typing import Any, Callable, Mapping

import torch
from torch import nn

from dmfusion_torch.models.common import init_params
from dmfusion_torch.parallel.mesh import Mesh, check_model
from dmfusion_torch.train.losses import l1, mse
from dmfusion_torch.train.optim import adam_beta, reset_state

NoiseFn = Callable[[torch.Tensor, torch.Tensor],
                   tuple[torch.Tensor, torch.Tensor]]
COLLECT = ("all", "first", "none")


def seeded_noise(seed: int, device: torch.device | str) -> NoiseFn:
    """A draw of two standard normal images shaped like ``m`` and ``p``,
    in that order, from one ``torch.Generator`` on ``device`` seeded with
    ``seed``."""
    gen = torch.Generator(device=device).manual_seed(int(seed))

    def draw(m: torch.Tensor, p: torch.Tensor):
        return (torch.randn(m.shape, generator=gen, device=m.device,
                            dtype=m.dtype),
                torch.randn(p.shape, generator=gen, device=p.device,
                            dtype=p.dtype))
    return draw


def _params(nets: Mapping[str, nn.Module]) -> list[nn.Parameter]:
    return [p for net in nets.values() for p in net.parameters()]


class GanPrograms:
    def __init__(self, gen_p: nn.Module, gen_m: nn.Module,
                 disc_p: nn.Module, disc_m: nn.Module,
                 cfg: Mapping[str, Any], noise: NoiseFn | None = None,
                 mesh: Mesh | None = None):
        self.gens = {"gP": gen_p, "gM": gen_m}
        self.discs = {"dP": disc_p, "dM": disc_m}
        self.nets = {**self.gens, **self.discs}
        self.mesh = mesh
        if mesh is not None:
            for net in self.nets.values():
                check_model(net)
        d = cfg["dqtl"]
        self.l_cy, self.l_id, self.l_ad = (float(d["l_cy"]), float(d["l_id"]),
                                           float(d["l_ad"]))
        self._g_params = _params(self.gens)
        self.opt_g = adam_beta(self._g_params, float(d["lr"]))
        self.opt_d = adam_beta(_params(self.discs), float(d["lr"]))
        self.noise = noise or seeded_noise(int(cfg["seed"]) + 1,
                                           self._g_params[0].device)
        self._take_rank0_params()

    def init(self, generator: torch.Generator) -> None:
        """Seed the four nets from ``generator``, in the order gP, gM, dP,
        dM, and zero both optimizers' state."""
        for net in self.nets.values():
            init_params(net, generator)
        self._take_rank0_params()
        reset_state(self.opt_g)
        reset_state(self.opt_d)

    @torch.no_grad()
    def _take_rank0_params(self) -> None:
        """Under a mesh, rank 0's parameters on every rank."""
        if self.mesh is not None:
            self.mesh.broadcast_all_(_params(self.nets))

    def _reduce(self, params: list[nn.Parameter],
                loss: torch.Tensor) -> torch.Tensor:
        """Under a mesh, average ``params``' gradients and the detached
        ``loss`` over the ranks, as one collective; returns the loss."""
        loss = loss.detach()
        if self.mesh is None:
            return loss
        grads = []
        for q in params:
            if q.grad is None:
                q.grad = torch.zeros_like(q)
            grads.append(q.grad)
        loss = loss.float().reshape(1).clone()
        self.mesh.mean_all_([*grads, loss])
        self.mesh.sync_peers_(grads)
        return loss[0]

    # -- one D + G step ----------------------------------------------------
    def step(self, m: torch.Tensor, p: torch.Tensor, n_m: torch.Tensor,
             n_p: torch.Tensor) -> dict[str, torch.Tensor]:
        """One discriminator step, then one generator step against the
        updated discriminators; returns the fakes made before the
        generators' update and both losses (detached, on the device).
        Under a mesh the tensors are the rank's shard, the fakes the rank's,
        and the losses the ranks' mean."""
        g_p, g_m = self.gens["gP"], self.gens["gM"]
        d_p, d_m = self.discs["dP"], self.discs["dM"]
        fake_pan = g_p(n_m)
        fake_ms = g_m(n_p)

        self.opt_d.zero_grad(set_to_none=True)
        d_p_real, d_p_fake = d_p(p), d_p(fake_pan.detach())
        d_m_real, d_m_fake = d_m(m), d_m(fake_ms.detach())
        loss_p = (mse(d_p_real, torch.ones_like(d_p_real))
                  + mse(d_p_fake, torch.zeros_like(d_p_fake)))
        loss_m = (mse(d_m_real, torch.ones_like(d_m_real))
                  + mse(d_m_fake, torch.zeros_like(d_m_fake)))
        d_loss = loss_p + loss_m
        d_loss.backward()
        d_loss = self._reduce(_params(self.discs), d_loss)
        self.opt_d.step()

        # The fakes above, with their graph, stand for dmfusion's recomputed
        # f_pan and f_ms: the generators have not changed since.
        self.opt_g.zero_grad(set_to_none=True)
        d_p_fake, d_m_fake = d_p(fake_pan), d_m(fake_ms)
        adv = (mse(d_p_fake, torch.ones_like(d_p_fake))
               + mse(d_m_fake, torch.ones_like(d_m_fake)))
        cycle_ms, cycle_pan = g_m(fake_pan), g_p(fake_ms)
        cyc = l1(n_m, cycle_ms) + l1(n_p, cycle_pan)
        ident = l1(n_m, g_m(n_m)) + l1(n_p, g_p(n_p))
        # Cross reconstruction ("adversarial" L1 in the reference).
        adv_pan, adv_ms = g_p(cycle_ms), g_m(cycle_pan)
        cross = l1(n_m, adv_ms) + l1(n_p, adv_pan)
        g_loss = (adv + self.l_cy * cyc + self.l_id * ident
                  + self.l_ad * cross) / 2.0
        g_loss.backward(inputs=self._g_params)
        g_loss = self._reduce(self._g_params, g_loss)
        self.opt_g.step()
        return {"fake_pan": fake_pan.detach(), "fake_ms": fake_ms.detach(),
                "d_loss": d_loss, "g_loss": g_loss}

    def _shard(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's contiguous equal shard of a batch (all of it on one
        rank)."""
        if self.mesh is None:
            return t
        b = t.shape[0]
        if b % self.mesh.data:
            raise ValueError(f"a GAN batch of {b} tiles does not divide "
                             f"over {self.mesh.data} ranks")
        lo, hi = self.mesh.bounds(b)
        return t[lo:hi]

    def _rows(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's fakes of a batch, in batch order."""
        return t if self.mesh is None else self.mesh.rows(t)

    def train_epoch(self, tiles_m: torch.Tensor, tiles_p: torch.Tensor,
                    collect: str = "all") -> dict[str, torch.Tensor]:
        """(steps, B, t, t, C) tile batches -> outputs: ``d_loss`` and
        ``g_loss`` (steps,) always; with 'all', ``fake_pan`` and
        ``fake_ms`` (steps, B, t, t, C), every step's; with 'first', the
        first batch's (B, t, t, C); with 'none', no fakes.  Under a mesh
        the fakes are every rank's, on every rank."""
        if collect not in COLLECT:
            raise ValueError(f"collect {collect!r} is not one of {COLLECT}")
        out: dict[str, torch.Tensor] = {}
        if collect == "all":
            # fake_pan comes from MS-shaped noise, fake_ms from PAN-shaped.
            out["fake_pan"] = torch.empty_like(tiles_m)
            out["fake_ms"] = torch.empty_like(tiles_p)
        d_losses, g_losses = [], []
        for i in range(tiles_m.shape[0]):
            m, p = tiles_m[i], tiles_p[i]
            # The whole batch's noise on every rank; the step takes its rows.
            r = self.step(*map(self._shard, (m, p, *self.noise(m, p))))
            d_losses.append(r["d_loss"])
            g_losses.append(r["g_loss"])
            if collect == "all":
                out["fake_pan"][i].copy_(self._rows(r["fake_pan"]))
                out["fake_ms"][i].copy_(self._rows(r["fake_ms"]))
            elif collect == "first" and i == 0:
                out["fake_pan"], out["fake_ms"] = (self._rows(r["fake_pan"]),
                                                   self._rows(r["fake_ms"]))
        out["d_loss"] = torch.stack(d_losses)
        out["g_loss"] = torch.stack(g_losses)
        return out
