"""S2D_nd, the new_depseg "model2" generation and its "4dis" variant (the
JAX package's ``models/s2d_nd.py``, reference my_seg_depth/new_depseg/
model2.py and model3.py).

Nets: two DenseNet trunks (``GeneralNet2`` in mode 'R'), G_1 for the
synthetic image and G_2 for the real one, each giving its 1024-channel PSP
features; the shared decoders Seg_de (``SEG``, 28 classes) and Dep_de
(``DEP`` with its tanh head), both with plain-ReLU DeconvBlocks, over
those features; and the critic: Dis_en (``DiscriminatorSeg``) over the
features, or with ``--nd_4dis`` the twin critics Dis0_en and Dis1_en
(``Dis2SegDF``, 28 sigmoid channels) over their channels [0, 256) and
[256, 512). One train step, six phases in the JAX step's order:

1. ``D1``: the critic on fresh, detached trunk forwards. Model2: BCE(syn
   → real) + BCE(real → fake) + the WGAN-GP penalty, the targets inverted
   as the reference has them (syn is the critic's "real" class), one SGD
   step at lr/3 (plain, no momentum: optax ``sgd``). 4dis: each twin
   BCE(syn → fake) + BCE(real → real) on its slice, no penalty, one Adam
   step at lr each;
2. ``G_1``: G_1 ← CE(syn seg) + L1(syn depth) through Seg_de and Dep_de;
3. ``G_2``: G_2 ← CE(real seg) + the adversarial term. Model2: BCE(Dis_en(
   real) → real). 4dis: BCE(twins(real) → fake), the double inversion of
   model3 kept as written; the reported loss adds 3 × ``real_dep_loss`` of
   Dep_de on the detached real features, which carries no gradient;
4. ``Seg``: Seg_de ← 1.3 × CE(real) on the features from before the trunks'
   update; its syn forward runs for the statistics only;
5. ``Dep``: Dep_de ← L1(syn depth); model2 also runs the real forward, for
   the statistics only (model3 moved it into phase 3);
6. ``D2``: phase 1 again on the updated nets; its losses are the step's.

The penalty's ``alpha`` (one for each D phase) is drawn on the CPU from
``step_generator``, where the JAX step draws it from a key: the card and
the CPU draw alike and a resumed run draws what the run would have.
BatchNorm statistics move as in the JAX step: G_1 ×3, G_2 ×3, Seg_de ×4,
Dep_de ×3 a step. Adam at lr/2 and eps 1e-8 for G_1, G_2, Seg_de and
Dep_de; no LR schedule.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from . import register_model
from .base_model import ModelState
from .networks import l1_loss
from .s2d_base import PhasedModel
from .s2d_df import two_trunk_eval
from .s2d_networks import (ND_SLICE, bce_gan_loss, calc_gradient_penalty,
                           define_s2d_nd_nets, real_dep_loss)
from .seg_network import cross_entropy_loss, seg_accuracy

TWINS = ("Dis0_en", "Dis1_en")


def _ce(logits, labels):
    return cross_entropy_loss(logits, labels, 255)


@register_model("S2D_nd")
class S2DNDModel(PhasedModel):
    loss_names = ("G_1", "G_2", "G2_dis", "seg_real", "dep_syn",
                  "D_syn", "D_real", "gp", "acc_syn", "acc_real")
    visual_names = ("syn_img", "real_img", "syn_seg_l", "real_seg_l",
                    "syn_seg_pre", "real_seg_pre", "syn_dep_l", "syn_dep_pre",
                    "real_dep_pre")
    model_names = ("G_1", "G_2", "Dis_en", "Seg_de", "Dep_de")
    lr_opt_names = ()
    define_nets = staticmethod(define_s2d_nd_nets)

    def __init__(self, cfg, device=None):
        super().__init__(cfg, device)
        if cfg.nd_4dis:
            self.model_names = ("G_1", "G_2", *TWINS, "Seg_de", "Dep_de")
            self.loss_names = ("G_1", "G_2", "G2_dis", "seg_real", "dep_syn",
                               "dep_real", "D_syn", "D_real", "acc_syn",
                               "acc_real")

    def _lr(self, name):
        return self.cfg.lr if name in TWINS else self.cfg.lr / 2

    def _optimizer(self, name, params):
        if name == "Dis_en":
            return torch.optim.SGD(params, lr=self.cfg.lr / 3)
        return super()._optimizer(name, params)

    def gp_alphas(self, state: ModelState) -> torch.Tensor:
        """The two D phases' interpolation weights, on the CPU."""
        return torch.rand(2, generator=self.step_generator(state))

    def _ctx(self, state, batch):
        ctx = super()._ctx(state, batch)
        ctx["alphas"] = self.gp_alphas(state)
        return ctx

    # ---- the phases: each updates ``state`` and ``ctx`` in place ----
    def _d_phase(self, state, ctx, i):
        nets = state.nets
        with torch.no_grad():
            f1s = nets["G_1"](ctx["syn_img"], "R")[1]
            f1r = nets["G_2"](ctx["real_img"], "R")[1]
        if self.cfg.nd_4dis:
            l_syn = l_real = 0.0
            for k, name in enumerate(TWINS):
                sl = slice(ND_SLICE * k, ND_SLICE * (k + 1))
                ls = bce_gan_loss(nets[name](f1s[:, sl]), False)
                lr = bce_gan_loss(nets[name](f1r[:, sl]), True)
                self._step(state, (name,), ls + lr)
                l_syn, l_real = l_syn + ls.detach(), l_real + lr.detach()
            ctx["metrics"].update(D_syn=l_syn, D_real=l_real)
            return
        d = nets["Dis_en"]
        l_syn = bce_gan_loss(d(f1s), True)
        l_real = bce_gan_loss(d(f1r), False)
        gp = calc_gradient_penalty(d, f1r, f1s,
                                   ctx["alphas"][i].to(self.device))
        self._step(state, ("Dis_en",), l_syn + l_real + gp)
        ctx["metrics"].update(D_syn=l_syn.detach(), D_real=l_real.detach(),
                              gp=gp.detach())

    def _phase_d1(self, state, ctx):
        self._d_phase(state, ctx, 0)

    def _phase_g1(self, state, ctx):
        nets, m = state.nets, ctx["metrics"]
        f1 = nets["G_1"](ctx["syn_img"], "R")[1]
        seg_syn, _ = nets["Seg_de"](f1)
        loss = (_ce(seg_syn, ctx["syn_seg_l"])
                + l1_loss(nets["Dep_de"](f1), ctx["syn_dep_l"]))
        self._step(state, ("G_1",), loss)
        m.update(G_1=loss.detach(),
                 acc_syn=seg_accuracy(seg_syn, ctx["syn_seg_l"], 255))
        ctx["syn_f1"] = f1.detach()

    def _phase_g2(self, state, ctx):
        nets, m = state.nets, ctx["metrics"]
        rf1 = nets["G_2"](ctx["real_img"], "R")[1]
        if self.cfg.nd_4dis:
            l_dis = sum(bce_gan_loss(
                nets[name](rf1[:, ND_SLICE * k:ND_SLICE * (k + 1)]), False)
                for k, name in enumerate(TWINS))
        else:
            l_dis = bce_gan_loss(nets["Dis_en"](rf1), True)
        seg_real, _ = nets["Seg_de"](rf1)
        loss = l_dis + _ce(seg_real, ctx["real_seg_l"])
        self._step(state, ("G_2",), loss)
        reported = loss.detach()
        if self.cfg.nd_4dis:
            with torch.no_grad():
                dep_real = nets["Dep_de"](rf1)
            m["dep_real"] = real_dep_loss(seg_real, ctx["syn_seg_l"],
                                          dep_real, ctx["syn_dep_l"])
            reported = reported + 3.0 * m["dep_real"]
        m.update(G_2=reported, G2_dis=l_dis.detach(),
                 acc_real=seg_accuracy(seg_real, ctx["real_seg_l"], 255))
        ctx["real_f1"] = rf1.detach()

    def _phase_seg(self, state, ctx):
        seg = state.nets["Seg_de"]
        with torch.no_grad():
            seg(ctx["syn_f1"])
        loss = 1.3 * _ce(seg(ctx["real_f1"])[0], ctx["real_seg_l"])
        self._step(state, ("Seg_de",), loss)
        ctx["metrics"]["seg_real"] = loss.detach()

    def _phase_dep(self, state, ctx):
        dep = state.nets["Dep_de"]
        loss = l1_loss(dep(ctx["syn_f1"]), ctx["syn_dep_l"])
        if not self.cfg.nd_4dis:
            with torch.no_grad():
                dep(ctx["real_f1"])
        self._step(state, ("Dep_de",), loss)
        ctx["metrics"]["dep_syn"] = loss.detach()

    def _phase_d2(self, state, ctx):
        self._d_phase(state, ctx, 1)

    PHASES = (("D1", _phase_d1), ("G_1", _phase_g1), ("G_2", _phase_g2),
              ("Seg", _phase_seg), ("Dep", _phase_dep), ("D2", _phase_d2))

    # ------------------------------------------------------------------
    def eval_step(self, state: ModelState, batch
                  ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
        """Eval-mode losses (the real ones where the batch has real labels)
        and the visuals: images, labels, depth and the predictions."""
        return two_trunk_eval(self, state, batch, real_dep=False)
