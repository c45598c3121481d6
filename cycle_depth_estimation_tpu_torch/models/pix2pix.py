"""pix2pix: aligned-pair conditional GAN, a U-Net G and a PatchGAN D on the
concatenated (A, B) pair (the JAX package's ``models/pix2pix.py``,
reference models/pix2pix_model.py:7-111).

One train step is the JAX package's, in this order:

1. ``fake_B = G(real_A)`` in train mode (G's BatchNorm statistics move
   once);
2. the D update on the pooled, detached fake pair ``cat(real_A, fake_B)``
   and the real pair ``cat(real_A, real_B)``: D in train mode on the fake
   pair, then on the real pair (its statistics move twice),
   ``0.5·(fake + real)`` GAN terms, one Adam step on D;
3. the G update against the *updated* D: D in train mode on
   ``cat(real_A, fake_B)`` (its statistics move a third time), the GAN term
   plus λ_L1 · L1(fake_B, real_B), one Adam step on G with D frozen.

The JAX step runs G a second time inside the G loss with the same
parameters, statistics and dropout key, so it reuses the forward of step 1
here; its statistics from that pass are dropped there, as they are never
made here. Losses are fp32 means; ``--dtype bfloat16`` runs every conv in
bf16 with fp32 parameters and Adam state (``ops.layers.set_compute_dtype``).
Under ``--parallel sp`` (``parallel/spatial.py``) G and D run on this
rank's rows of the images (the AB pairs are concatenated on channels, row
for row), the GAN and L1 means are over the whole planes, the BatchNorm
statistics over ``data`` × ``model``, and ``eval_step`` gathers its
visuals' height.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from . import register_model
from ..config import Config
from ..ops.layers import set_compute_dtype
from ..parallel.collectives import gather_spatial
from ..utils.image_pool import ImagePool
from .base_model import BaseModel, ModelState, make_optimizer
from .networks import define_D, define_G, gan_loss, l1_loss


@register_model("pix2pix")
class Pix2PixModel(BaseModel):
    loss_names = ("G_GAN", "G_L1", "D_real", "D_fake")
    visual_names = ("real_A", "fake_B", "real_B")
    model_names = ("G", "D")
    lr_opt_names = ("G", "D")

    def __init__(self, cfg: Config, device=None):
        super().__init__(cfg, device)
        self.gan_mode = "vanilla" if cfg.no_lsgan else "lsgan"

    def init_state(self, seed: int = None) -> ModelState:
        """Random init of G and D from ``seed`` (default ``cfg.seed``),
        their optimizers (both at ``lr``, the reference's) and the pool of
        fake pairs, on the model's device."""
        cfg = self.cfg
        gen = torch.Generator().manual_seed(cfg.seed if seed is None else seed)
        nets = {
            "G": define_G(cfg.input_nc, cfg.output_nc, cfg.ngf, cfg.net_g,
                          norm=cfg.norm, use_dropout=not cfg.no_dropout,
                          init_type=cfg.init_type, init_gain=cfg.init_gain,
                          generator=gen),
            "D": define_D(cfg.input_nc + cfg.output_nc, cfg.ndf, cfg.net_d,
                          cfg.n_layers_d, norm=cfg.norm, use_sigmoid=False,
                          init_type=cfg.init_type, init_gain=cfg.init_gain,
                          generator=gen),
        }
        nets = {k: set_compute_dtype(v.to(self.device), cfg.compute_dtype())
                for k, v in nets.items()}
        optimizers = {k: make_optimizer(nets[k].parameters(), cfg.lr,
                                        cfg.beta1) for k in ("G", "D")}
        pool = ImagePool(
            cfg.pool_size, self.device, generator=torch.Generator().manual_seed(
                int(torch.randint(2 ** 62, (), generator=gen))))
        return ModelState(nets=nets, optimizers=optimizers,
                          pools={"fake_AB": pool})

    def _inputs(self, batch):
        return (batch["A"].to(self.device, torch.float32),
                batch["B"].to(self.device, torch.float32))

    # ------------------------------------------------------------------
    def train_step(self, state: ModelState, batch
                   ) -> Tuple[ModelState, Dict[str, torch.Tensor]]:
        """One D update then one G update; ``batch`` holds NCHW ``A`` and
        ``B`` in [-1, 1]. Updates ``state`` in place and returns it with
        the step's metrics."""
        cfg = self.cfg
        real_A, real_B = self._inputs(batch)
        G, D = state.nets["G"], state.nets["D"]
        opt = state.optimizers
        G.train()
        D.train()
        fake_B = G(real_A)

        # ---- D update on the pooled, detached fake pair ----
        fake_AB = state.pools["fake_AB"].query(
            torch.cat([real_A, fake_B.detach()], 1))
        loss_D_fake = gan_loss(D(fake_AB), False, self.gan_mode)
        loss_D_real = gan_loss(D(torch.cat([real_A, real_B], 1)), True,
                               self.gan_mode)
        opt["D"].zero_grad(set_to_none=True)
        (0.5 * (loss_D_fake + loss_D_real)).backward()
        self.optimizer_step(opt["D"])

        # ---- G update against the updated D; D frozen ----
        for p in D.parameters():
            p.requires_grad_(False)
        loss_G_GAN = gan_loss(D(torch.cat([real_A, fake_B], 1)), True,
                              self.gan_mode)
        loss_G_L1 = l1_loss(fake_B, real_B) * cfg.lambda_l1
        opt["G"].zero_grad(set_to_none=True)
        (loss_G_GAN + loss_G_L1).backward()
        self.optimizer_step(opt["G"])
        for p in D.parameters():
            p.requires_grad_(True)
        state.step += 1
        return state, self.metrics_dict(G_GAN=loss_G_GAN, G_L1=loss_G_L1,
                                        D_real=loss_D_real, D_fake=loss_D_fake)

    def eval_step(self, state: ModelState, batch
                  ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
        """Losses of the current nets on ``batch`` (eval mode: running
        statistics, no dropout; D on the unpooled pairs) and the visuals,
        without updating anything."""
        real_A, real_B = self._inputs(batch)
        G, D = state.nets["G"], state.nets["D"]
        G.eval()
        D.eval()
        with torch.no_grad():
            fake_B = G(real_A)
            pred_fake = D(torch.cat([real_A, fake_B], 1))
            pred_real = D(torch.cat([real_A, real_B], 1))
            metrics = self.metrics_dict(
                G_GAN=gan_loss(pred_fake, True, self.gan_mode),
                G_L1=l1_loss(fake_B, real_B) * self.cfg.lambda_l1,
                D_real=gan_loss(pred_real, True, self.gan_mode),
                D_fake=gan_loss(pred_fake, False, self.gan_mode))
        visuals = dict(real_A=real_A, fake_B=fake_B, real_B=real_B)
        return metrics, {k: gather_spatial(v) for k, v in visuals.items()}
