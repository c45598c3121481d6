"""semantic_trans, the objectives of the trymulti/semantic_trans generation
on the S2D pipeline (the JAX package's ``models/semantic_trans.py``,
reference my_seg_depth/trymulti/semantic_trans/model5.py).

It is ``S2D`` with:

- four ``StarDiscriminator`` critics: DIS over (refined depth, seg label
  as a float) pairs, and Dis_80, Dis_160 and Dis_320 over depth maps.
  Dis_80 is built, saved and given an optimizer, and never stepped, as in
  the reference;
- ``bce_dep_loss_truncated`` (the o_m BCE alone) as ``rd_syn``'s band
  criterion;
- in ``rd_real``, + 0.2 · LSGAN(Dis_160(b/4), fake) + LSGAN(Dis_320(b/2),
  fake), b being band 1 of R_D's four bands, resized to 1/4 and 1/2
  (bilinear, corners aligned);
- a ``post`` phase after ``fd``: DIS ← LSGAN(real pair → real) +
  LSGAN(syn pair → fake) + the WGAN-GP penalty (λ 10, DIS the critic),
  both pairs from the detached refined depths of ``rd_real`` and
  ``rd_syn``; then Dis_160 and Dis_320 ← LSGAN(real → real) + LSGAN(syn →
  fake) on the band-1 maps of those phases, each gradient clipped to
  global norm 1 by optax's rule (``clip_grad_global_norm_``) before its
  Adam step.

Adam: the six S2D nets as S2D has them (``adam_eps``); the four critics at
lr/4 and eps 1e-8 whatever ``adam_eps`` says, as the JAX model builds
them. The penalty's alpha, one a step, is drawn on the CPU from
``step_generator`` (seeded by ``seed`` and the step), where the JAX step
draws it from its key: the card and the CPU draw alike, and a resumed run
draws what the run would have. S2D's ``--remat`` applies.
"""

from __future__ import annotations

import torch

from . import register_model
from .base_model import ModelState, make_optimizer
from .networks import gan_loss
from .s2d import S2DModel
from .s2d_networks import (bce_dep_loss_truncated, calc_gradient_penalty,
                           define_semantic_trans_nets)
from ..ops.layers import resize_bilinear

CRITICS = ("DIS", "Dis_80", "Dis_160", "Dis_320")


def downscaled(x: torch.Tensor, factor: int) -> torch.Tensor:
    """NCHW ``x`` at 1/``factor`` of its size (bilinear, corners aligned:
    the reference's UpsamplingBilinear2d)."""
    if factor == 1:
        return x
    return resize_bilinear(x, (x.shape[2] // factor, x.shape[3] // factor),
                           align_corners=True)


def depth_label_pair(dep: torch.Tensor, seg_l: torch.Tensor) -> torch.Tensor:
    """DIS's input: the N1HW depth and the NHW label map as a float channel
    (255 where ignored, as the JAX model has it)."""
    return torch.cat([dep.float(), seg_l.float()[:, None]], 1)


@register_model("semantic_trans")
class S2DSemanticTrans(S2DModel):
    loss_names = S2DModel.loss_names + ("DEP_DIS", "d160", "d320", "gp")
    model_names = S2DModel.model_names + CRITICS
    define_nets = staticmethod(define_semantic_trans_nets)
    band_criterion = staticmethod(bce_dep_loss_truncated)
    clip_norms = {"Dis_160": 1.0, "Dis_320": 1.0}
    GP_LAMBDA = 10.0

    def _optimizer(self, name, params):
        if name in CRITICS:
            return make_optimizer(params, self.cfg.lr / 4, self.cfg.beta1)
        return super()._optimizer(name, params)

    def gp_alpha(self, state: ModelState) -> torch.Tensor:
        """The step's penalty interpolation weight, on the CPU."""
        return torch.rand((), generator=self.step_generator(state))

    def _ctx(self, batch, state: ModelState = None) -> dict:
        ctx = super()._ctx(batch, state)
        ctx["alpha"] = self.gp_alpha(state)
        return ctx

    def rd_real_extra(self, state, dep_4):
        nets, band = state.nets, dep_4[1]
        return (0.2 * gan_loss(nets["Dis_160"](downscaled(band, 4)), False)
                + gan_loss(nets["Dis_320"](downscaled(band, 2)), False))

    def _phase_post(self, state, ctx):
        nets, m = state.nets, ctx["metrics"]
        real = depth_label_pair(ctx["real_dep_ref"], ctx["real_seg_l"])
        syn = depth_label_pair(ctx["syn_dep_ref"], ctx["syn_seg_l"])
        dis = nets["DIS"]
        gp = calc_gradient_penalty(dis, real, syn,
                                   ctx["alpha"].to(self.device), self.GP_LAMBDA)
        loss = gan_loss(dis(real), True) + gan_loss(dis(syn), False) + gp
        self._step(state, "DIS", loss)
        m.update(DEP_DIS=loss.detach(), gp=gp.detach())
        for name, factor, key in (("Dis_160", 4, "d160"),
                                  ("Dis_320", 2, "d320")):
            net = nets[name]
            real, syn = (downscaled(ctx[f"{d}_dep_4"][1], factor)
                         for d in ("real", "syn"))
            loss = gan_loss(net(real), True) + gan_loss(net(syn), False)
            self._step(state, name, loss)
            m[key] = loss.detach()

    PHASES = S2DModel.PHASES + (("post", _phase_post),)
