"""SegCycle: CycleGAN plus two U-Net encoder/decoder pairs that segment both
domains (the JAX package's ``models/seg_cycle.py``, reference
models/seg_cycle.py:9-180).

One train step is the JAX package's, in this order:

1. the six generator passes ``fake_B, rec_A, fake_A, rec_B, idt_A, idt_B``
   (the identity losses are unconditional);
2. the four seg branches, in the JAX order, each a cross-entropy (ignore
   255) of the decoder's last output against the labels::

       segAreal = decoderA(encoderA(real_A))   vs lab_A
       segAfake = decoderA(encoderB(fake_B))   vs lab_A
       segBreal = decoderB(encoderB(real_B))   vs lab_B
       segBfake = decoderB(encoderA(fake_A))   vs lab_B

   ``fake_B`` and ``fake_A`` stay attached, so the seg losses reach the
   generators; the encoders' and decoders' BatchNorm statistics move in
   this order, as the JAX step threads them;
3. both Ds in train mode on the fakes (D frozen), the LSGAN, cycle and
   identity terms; one Adam step on the G group: ``G_A``, ``G_B``, both
   encoders and both decoders;
4. one D update on the pool-mixed, detached fakes of step 1 (from before
   the G update), D on real then on fake, one Adam step on D.

Losses are fp32 means; ``--dtype bfloat16`` runs every conv in bf16 with
fp32 parameters and Adam state.
"""

from __future__ import annotations

import itertools
from typing import Dict, Tuple

import torch

from . import register_model
from ..config import Config
from ..ops.layers import set_compute_dtype
from ..utils.image_pool import ImagePool
from .base_model import BaseModel, ModelState, make_optimizer
from .encoder_decoder import define_decoder, define_encoder
from .networks import define_D, define_G, gan_loss, l1_loss
from .seg_network import cross_entropy_loss

G_GROUP = ("G_A", "G_B", "encoderA", "encoderB", "decoderA", "decoderB")


@register_model("seg_cycle")
class SegCycleModel(BaseModel):
    loss_names = ("D_A", "G_A", "cycle_A", "idt_A", "D_B", "G_B", "cycle_B",
                  "idt_B", "segAreal", "segBreal", "segAfake", "segBfake")
    visual_names = ("real_A", "fake_B", "rec_A", "lab_A", "segAreal",
                    "segAfake", "idt_A", "real_B", "fake_A", "rec_B", "lab_B",
                    "segBreal", "segBfake", "idt_B")
    model_names = ("G_A", "G_B", "D_A", "D_B", "encoderA", "encoderB",
                   "decoderA", "decoderB")
    lr_opt_names = ("G", "D")

    NC_SYN = 22   # decoderA's classes
    NC_REAL = 28  # decoderB's classes

    def __init__(self, cfg: Config, device=None):
        super().__init__(cfg, device)
        self.gan_mode = "vanilla" if cfg.no_lsgan else "lsgan"

    def init_state(self, seed: int = None) -> ModelState:
        """Random init of the eight nets from ``seed`` (default
        ``cfg.seed``), the two optimizers and the two pools."""
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
            "encoderA": define_encoder(cfg.input_nc, cfg.ngf, gen),
            "encoderB": define_encoder(cfg.output_nc, cfg.ngf, gen),
            "decoderA": define_decoder(self.NC_SYN, cfg.ngf, gen),
            "decoderB": define_decoder(self.NC_REAL, cfg.ngf, gen),
        }
        nets = {k: set_compute_dtype(v.to(self.device), cfg.compute_dtype())
                for k, v in nets.items()}
        optimizers = {
            "G": make_optimizer(itertools.chain(
                *(nets[k].parameters() for k in G_GROUP)), cfg.lr, cfg.beta1),
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
    def _inputs(self, batch):
        f = lambda k: batch[k].to(self.device, torch.float32)  # noqa: E731
        lab = lambda k: batch[k].to(self.device, torch.long)   # noqa: E731
        return (f("img_source"), f("img_target"), lab("lab_source"),
                lab("lab_target"))

    def _g_losses(self, nets, real_A, real_B, lab_A, lab_B):
        cfg = self.cfg
        G_A, G_B = nets["G_A"], nets["G_B"]
        fake_B = G_A(real_A)
        rec_A = G_B(fake_B)
        fake_A = G_B(real_B)
        rec_B = G_A(fake_A)
        idt_A = G_A(real_B)
        idt_B = G_B(real_A)
        loss_idt_A = l1_loss(idt_A, real_B) * cfg.lambda_b * cfg.lambda_identity
        loss_idt_B = l1_loss(idt_B, real_A) * cfg.lambda_a * cfg.lambda_identity

        def seg(enc, dec, x, gt):
            logits = nets[dec](nets[enc](x))[-1]
            return cross_entropy_loss(logits, gt, 255), logits

        s_ar, seg_ar = seg("encoderA", "decoderA", real_A, lab_A)
        s_af, seg_af = seg("encoderB", "decoderA", fake_B, lab_A)
        s_br, seg_br = seg("encoderB", "decoderB", real_B, lab_B)
        s_bf, seg_bf = seg("encoderA", "decoderB", fake_A, lab_B)

        loss_G_A = gan_loss(nets["D_A"](fake_B), True, self.gan_mode)
        loss_G_B = gan_loss(nets["D_B"](fake_A), True, self.gan_mode)
        loss_cycle_A = l1_loss(rec_A, real_A) * cfg.lambda_a
        loss_cycle_B = l1_loss(rec_B, real_B) * cfg.lambda_b
        total = (loss_G_A + loss_G_B + loss_cycle_A + loss_cycle_B
                 + loss_idt_A + loss_idt_B + s_af + s_ar + s_bf + s_br)
        aux = dict(fake_B=fake_B, fake_A=fake_A, rec_A=rec_A, rec_B=rec_B,
                   idt_A=idt_A, idt_B=idt_B, segAreal=seg_ar, segAfake=seg_af,
                   segBreal=seg_br, segBfake=seg_bf)
        losses = dict(G_A=loss_G_A, G_B=loss_G_B, cycle_A=loss_cycle_A,
                      cycle_B=loss_cycle_B, idt_A=loss_idt_A,
                      idt_B=loss_idt_B, segAreal=s_ar, segAfake=s_af,
                      segBreal=s_br, segBfake=s_bf)
        return total, aux, losses

    def _d_losses(self, nets, real_B, fake_B, real_A, fake_A):
        def d_basic(net, real, fake):
            return 0.5 * (gan_loss(net(real), True, self.gan_mode)
                          + gan_loss(net(fake), False, self.gan_mode))

        return (d_basic(nets["D_A"], real_B, fake_B),
                d_basic(nets["D_B"], real_A, fake_A))

    # ------------------------------------------------------------------
    def train_step(self, state: ModelState, batch
                   ) -> Tuple[ModelState, Dict[str, torch.Tensor]]:
        """One G-group update and one D update; ``batch`` holds NCHW
        ``img_source``/``img_target`` in [-1, 1] and NHW
        ``lab_source``/``lab_target``. Updates ``state`` in place."""
        real_A, real_B, lab_A, lab_B = self._inputs(batch)
        nets, opt = state.nets, state.optimizers
        for net in nets.values():
            net.train()
        d_params = [p for k in ("D_A", "D_B") for p in nets[k].parameters()]

        for p in d_params:
            p.requires_grad_(False)
        total, aux, losses = self._g_losses(nets, real_A, real_B, lab_A,
                                            lab_B)
        opt["G"].zero_grad(set_to_none=True)
        total.backward()
        self.optimizer_step(opt["G"])
        for p in d_params:
            p.requires_grad_(True)

        fake_B_mix = state.pools["fake_B"].query(aux["fake_B"].detach())
        fake_A_mix = state.pools["fake_A"].query(aux["fake_A"].detach())
        loss_D_A, loss_D_B = self._d_losses(nets, real_B, fake_B_mix, real_A,
                                            fake_A_mix)
        opt["D"].zero_grad(set_to_none=True)
        (loss_D_A + loss_D_B).backward()
        self.optimizer_step(opt["D"])
        state.step += 1
        return state, self.metrics_dict(D_A=loss_D_A, D_B=loss_D_B, **losses)

    def eval_step(self, state: ModelState, batch
                  ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
        """Losses of the current nets on ``batch`` (eval mode; Ds on the
        unpooled fakes) and the visuals: images, label maps and the four
        predicted label maps (argmax over the classes)."""
        real_A, real_B, lab_A, lab_B = self._inputs(batch)
        for net in state.nets.values():
            net.eval()
        with torch.no_grad():
            _, aux, losses = self._g_losses(state.nets, real_A, real_B, lab_A,
                                            lab_B)
            loss_D_A, loss_D_B = self._d_losses(state.nets, real_B,
                                                aux["fake_B"], real_A,
                                                aux["fake_A"])
        visuals = dict(real_A=real_A, fake_B=aux["fake_B"], rec_A=aux["rec_A"],
                       lab_A=lab_A, segAreal=aux["segAreal"].argmax(1),
                       segAfake=aux["segAfake"].argmax(1), idt_A=aux["idt_A"],
                       real_B=real_B, fake_A=aux["fake_A"], rec_B=aux["rec_B"],
                       lab_B=lab_B, segBreal=aux["segBreal"].argmax(1),
                       segBfake=aux["segBfake"].argmax(1), idt_B=aux["idt_B"])
        return self.metrics_dict(D_A=loss_D_A, D_B=loss_D_B, **losses), visuals
