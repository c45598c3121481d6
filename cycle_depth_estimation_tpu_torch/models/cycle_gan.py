"""CycleGAN: two generators, two discriminators, unpaired translation (the
JAX package's ``models/cycle_gan.py``, reference
models/cycle_gan_model.py:8-160).

One train step is the JAX package's, in this order:

1. the generator forward ``fake_B, rec_A, fake_A, rec_B, idt_A, idt_B``;
   both Ds in train mode on the fakes; the G loss (lsgan or vanilla GAN
   terms, λ-weighted L1 cycle and identity terms); one Adam step on G with
   D frozen (D's parameters take no gradient);
2. ``d_steps_per_g`` (default 4, the reference's quirk) D updates, each with
   a fresh pool query of the same fakes — those of step 1, from before the
   G update, detached — and one Adam step on D;
3. metrics: the G terms of step 1 and the last D pass's ``D_A``/``D_B``.

Losses are fp32 means. Under ``--parallel sp`` (``parallel/spatial.py``)
the four nets run on this rank's rows of the images, the means are over
the whole planes, and ``eval_step`` gathers its visuals' height. ``--dtype bfloat16`` runs every conv in bf16 with
fp32 parameters and Adam state (``ops.layers.set_compute_dtype``).
``--remat`` wraps each of the six generator applications in
``torch.utils.checkpoint`` (the JAX ``jax.checkpoint``): backward runs the
forward again instead of keeping its activations, and the BatchNorm
running statistics of that second forward are put back, so they move once
per application, as the JAX step threads them. Dropout draws the same mask
again (checkpoint restores the RNG state).
"""

from __future__ import annotations

import contextlib
import itertools
from typing import Dict, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from . import register_model
from ..config import Config
from ..ops.layers import running_stats_kept, set_compute_dtype
from ..parallel.collectives import gather_spatial
from ..utils.image_pool import ImagePool
from .base_model import BaseModel, ModelState, make_optimizer
from .networks import define_D, define_G, gan_loss, l1_loss


@register_model("cycle_gan")
class CycleGANModel(BaseModel):
    loss_names = ("D_A", "G_A", "cycle_A", "idt_A", "D_B", "G_B", "cycle_B",
                  "idt_B")
    visual_names = ("real_A", "fake_B", "rec_A", "idt_B",
                    "real_B", "fake_A", "rec_B", "idt_A")
    model_names = ("G_A", "G_B", "D_A", "D_B")
    lr_opt_names = ("G", "D")

    def __init__(self, cfg: Config, device=None):
        super().__init__(cfg, device)
        self.gan_mode = "vanilla" if cfg.no_lsgan else "lsgan"

    def init_state(self, seed: int = None) -> ModelState:
        """Random init of the four nets from ``seed`` (default ``cfg.seed``),
        their optimizers and the two pools, on the model's device."""
        cfg = self.cfg
        gen = torch.Generator().manual_seed(cfg.seed if seed is None else seed)
        g_kw = dict(norm=cfg.norm, use_dropout=not cfg.no_dropout,
                    init_type=cfg.init_type, init_gain=cfg.init_gain,
                    generator=gen)
        d_kw = dict(norm=cfg.norm, use_sigmoid=False, init_type=cfg.init_type,
                    init_gain=cfg.init_gain, generator=gen)
        nets = {
            "G_A": define_G(cfg.input_nc, cfg.output_nc, cfg.ngf, cfg.net_g,
                            **g_kw),
            "G_B": define_G(cfg.output_nc, cfg.input_nc, cfg.ngf, cfg.net_g,
                            **g_kw),
            "D_A": define_D(cfg.output_nc, cfg.ndf, cfg.net_d, cfg.n_layers_d,
                            **d_kw),
            "D_B": define_D(cfg.input_nc, cfg.ndf, cfg.net_d, cfg.n_layers_d,
                            **d_kw),
        }
        nets = {k: set_compute_dtype(v.to(self.device), cfg.compute_dtype())
                for k, v in nets.items()}
        optimizers = {
            "G": make_optimizer(itertools.chain(nets["G_A"].parameters(),
                                                nets["G_B"].parameters()),
                                cfg.lr, cfg.beta1),
            "D": make_optimizer(itertools.chain(nets["D_A"].parameters(),
                                                nets["D_B"].parameters()),
                                cfg.lr, cfg.beta1),
        }
        pools = {name: ImagePool(cfg.pool_size, self.device,
                                 generator=torch.Generator().manual_seed(
                                     int(torch.randint(2 ** 62, (),
                                                       generator=gen))))
                 for name in ("fake_A", "fake_B")}
        return ModelState(nets=nets, optimizers=optimizers, pools=pools)

    # ------------------------------------------------------------------
    def _apply_g(self, net, x):
        if not (self.cfg.remat and torch.is_grad_enabled()):
            return net(x)
        return checkpoint(net, x, use_reentrant=False, context_fn=lambda: (
            contextlib.nullcontext(), running_stats_kept(net)))

    def _g_losses(self, nets, real_A, real_B):
        cfg = self.cfg
        G_A, G_B = nets["G_A"], nets["G_B"]
        fake_B = self._apply_g(G_A, real_A)
        rec_A = self._apply_g(G_B, fake_B)
        fake_A = self._apply_g(G_B, real_B)
        rec_B = self._apply_g(G_A, fake_A)
        idt_A = self._apply_g(G_A, real_B)
        idt_B = self._apply_g(G_B, real_A)
        if cfg.lambda_identity > 0:
            loss_idt_A = (l1_loss(idt_A, real_B) * cfg.lambda_b
                          * cfg.lambda_identity)
            loss_idt_B = (l1_loss(idt_B, real_A) * cfg.lambda_a
                          * cfg.lambda_identity)
        else:
            loss_idt_A = loss_idt_B = torch.zeros((), device=real_A.device)
        loss_G_A = gan_loss(nets["D_A"](fake_B), True, self.gan_mode)
        loss_G_B = gan_loss(nets["D_B"](fake_A), True, self.gan_mode)
        loss_cycle_A = l1_loss(rec_A, real_A) * cfg.lambda_a
        loss_cycle_B = l1_loss(rec_B, real_B) * cfg.lambda_b
        loss_G = (loss_G_A + loss_G_B + loss_cycle_A + loss_cycle_B
                  + loss_idt_A + loss_idt_B)
        aux = dict(fake_B=fake_B, rec_A=rec_A, fake_A=fake_A, rec_B=rec_B,
                   idt_A=idt_A, idt_B=idt_B, G_A=loss_G_A, G_B=loss_G_B,
                   cycle_A=loss_cycle_A, cycle_B=loss_cycle_B,
                   idt_a=loss_idt_A, idt_b=loss_idt_B)
        return loss_G, aux

    def _d_losses(self, nets, real_B, fake_B, real_A, fake_A):
        def d_basic(net, real, fake):
            return 0.5 * (gan_loss(net(real), True, self.gan_mode)
                          + gan_loss(net(fake), False, self.gan_mode))

        return (d_basic(nets["D_A"], real_B, fake_B),
                d_basic(nets["D_B"], real_A, fake_A))

    def _metrics(self, aux, loss_D_A, loss_D_B):
        return self.metrics_dict(
            D_A=loss_D_A, G_A=aux["G_A"], cycle_A=aux["cycle_A"],
            idt_A=aux["idt_a"], D_B=loss_D_B, G_B=aux["G_B"],
            cycle_B=aux["cycle_B"], idt_B=aux["idt_b"])

    def _inputs(self, batch):
        return (batch["img_source"].to(self.device, torch.float32),
                batch["img_target"].to(self.device, torch.float32))

    # ------------------------------------------------------------------
    def train_step(self, state: ModelState, batch
                   ) -> Tuple[ModelState, Dict[str, torch.Tensor]]:
        """One G update and ``d_steps_per_g`` D updates; ``batch`` holds
        NCHW ``img_source`` (A) and ``img_target`` (B) in [-1, 1]. Updates
        ``state`` in place and returns it with the step's metrics."""
        cfg = self.cfg
        real_A, real_B = self._inputs(batch)
        nets, opt = state.nets, state.optimizers
        for net in nets.values():
            net.train()
        d_params = [p for k in ("D_A", "D_B") for p in nets[k].parameters()]

        # ---- G update; D frozen ----
        for p in d_params:
            p.requires_grad_(False)
        loss_G, aux = self._g_losses(nets, real_A, real_B)
        opt["G"].zero_grad(set_to_none=True)
        loss_G.backward()
        self.optimizer_step(opt["G"])
        for p in d_params:
            p.requires_grad_(True)
        fake_B, fake_A = aux["fake_B"].detach(), aux["fake_A"].detach()
        aux = {k: v.detach() for k, v in aux.items() if v.dim() == 0}

        # ---- D updates, each with a fresh pool query of the same fakes ----
        loss_D_A = loss_D_B = torch.zeros((), device=self.device)
        for _ in range(cfg.d_steps_per_g):
            fake_B_mix = state.pools["fake_B"].query(fake_B)
            fake_A_mix = state.pools["fake_A"].query(fake_A)
            loss_D_A, loss_D_B = self._d_losses(nets, real_B, fake_B_mix,
                                                real_A, fake_A_mix)
            opt["D"].zero_grad(set_to_none=True)
            (loss_D_A + loss_D_B).backward()
            self.optimizer_step(opt["D"])
        state.step += 1
        return state, self._metrics(aux, loss_D_A, loss_D_B)

    def eval_step(self, state: ModelState, batch
                  ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
        """Losses of the current nets on ``batch`` (Ds on the unpooled
        fakes) and the eight visuals, without updating anything."""
        real_A, real_B = self._inputs(batch)
        for net in state.nets.values():
            net.eval()
        with torch.no_grad():
            _, aux = self._g_losses(state.nets, real_A, real_B)
            loss_D_A, loss_D_B = self._d_losses(state.nets, real_B,
                                                aux["fake_B"], real_A,
                                                aux["fake_A"])
        visuals = dict(real_A=real_A, fake_B=aux["fake_B"], rec_A=aux["rec_A"],
                       real_B=real_B, fake_A=aux["fake_A"], rec_B=aux["rec_B"],
                       idt_A=aux["idt_A"], idt_B=aux["idt_B"])
        # under --parallel sp, each visual's whole height (over 'model')
        visuals = {k: gather_spatial(v) for k, v in visuals.items()}
        return self._metrics(aux, loss_D_A, loss_D_B), visuals
