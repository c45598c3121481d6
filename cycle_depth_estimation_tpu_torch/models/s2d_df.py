"""S2D_df, the deeperfeatures "model3" generation (the JAX package's
``models/s2d_df.py``, reference my_seg_depth/deeperfeatures/model3.py).

Nets: two DenseNet trunks (``GeneralNet2`` in mode 'R'), G_1 for the
synthetic image and G_2 for the real one, each giving its 1024-channel PSP
features; the shared skip-free decoders Seg_de (``SEGDF``, 28 classes) and
Dep_de (``DEPDF``) over them; and Dis0_en (``Dis2SegDF``), a 1×1 critic of
SEGDF's 512-channel features. One train step, five phases in the JAX
step's order:

1. ``G_1``: G_1 ← CE(syn seg) + L1(syn depth) through Seg_de and Dep_de
   (not updated), + 5 × LSGAN(Dis0_en(syn features), real) with
   ``--df_g1_adv``;
2. ``G_2``: G_2 ← CE(real seg); the reported G_2 loss adds 3 ×
   ``real_dep_loss`` of Dep_de on the detached real features, which
   carries no gradient;
3. ``Seg``: Seg_de ← CE(real) + ``df_adv_w`` × LSGAN(Dis0_en(syn
   features), real), on G_1's and G_2's features from before their update;
4. ``Dep``: Dep_de ← L1 of the syn depth on the updated Seg_de's features;
5. ``D``: Dis0_en ← ``df_d_real_w`` × LSGAN(real → real) + LSGAN(syn →
   fake), on fresh forwards in the order G_1, Seg_de, G_2, Seg_de.

GAN terms are MSE on the critic's sigmoid (this generation's GANLoss is
MSE whatever ``no_lsgan`` says); CE is unweighted. BatchNorm statistics
move as in the JAX step: G_1 ×2, G_2 ×2, Seg_de ×7, Dep_de ×3 a step.
Adam at eps 1e-8: lr/3 for G_1 and G_2, lr/2 for Seg_de and Dep_de, lr/5
for Dis0_en; no LR schedule.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from . import register_model
from .base_model import ModelState
from .networks import gan_loss, l1_loss
from .s2d_base import PhasedModel
from .s2d_networks import define_s2d_df_nets, real_dep_loss
from .seg_network import cross_entropy_loss, seg_accuracy


def _ce(logits, labels):
    return cross_entropy_loss(logits, labels, 255)


@register_model("S2D_df")
class S2DDFModel(PhasedModel):
    loss_names = ("G_1", "G_2", "seg_real", "adv_syn", "dep_syn", "dep_real",
                  "D_syn", "D_real", "acc_syn", "acc_real")
    visual_names = ("syn_img", "real_img", "syn_seg_l", "real_seg_l",
                    "syn_seg_pre", "real_seg_pre", "syn_dep_l", "syn_dep_pre",
                    "real_dep_pre")
    model_names = ("G_1", "G_2", "Dis0_en", "Seg_de", "Dep_de")
    lr_opt_names = ()
    define_nets = staticmethod(define_s2d_df_nets)
    LR_DIVISOR = {"G_1": 3, "G_2": 3, "Seg_de": 2, "Dep_de": 2, "Dis0_en": 5}

    def _lr(self, name):
        return self.cfg.lr / self.LR_DIVISOR[name]

    # ---- the phases: each updates ``state`` and ``ctx`` in place ----
    def _phase_g1(self, state, ctx):
        nets, m = state.nets, ctx["metrics"]
        _, f1 = nets["G_1"](ctx["syn_img"], "R")
        seg_syn, f2 = nets["Seg_de"](f1)
        loss = (_ce(seg_syn, ctx["syn_seg_l"])
                + l1_loss(nets["Dep_de"](f2), ctx["syn_dep_l"]))
        if self.cfg.df_g1_adv:
            loss = loss + 5.0 * gan_loss(nets["Dis0_en"](f2), True)
        self._step(state, ("G_1",), loss)
        m.update(G_1=loss.detach(),
                 acc_syn=seg_accuracy(seg_syn, ctx["syn_seg_l"], 255))
        ctx["syn_f1"] = f1.detach()

    def _phase_g2(self, state, ctx):
        nets, m = state.nets, ctx["metrics"]
        _, rf1 = nets["G_2"](ctx["real_img"], "R")
        seg_real, rf2 = nets["Seg_de"](rf1)
        l_seg = _ce(seg_real, ctx["real_seg_l"])
        with torch.no_grad():
            dep_real = nets["Dep_de"](rf2)
        l_dep_real = real_dep_loss(seg_real, ctx["syn_seg_l"], dep_real,
                                   ctx["syn_dep_l"])
        self._step(state, ("G_2",), l_seg)
        m.update(G_2=l_seg.detach() + 3.0 * l_dep_real, dep_real=l_dep_real,
                 acc_real=seg_accuracy(seg_real, ctx["real_seg_l"], 255))
        ctx["real_f1"] = rf1.detach()

    def _phase_seg(self, state, ctx):
        nets = state.nets
        _, syn_f2 = nets["Seg_de"](ctx["syn_f1"])
        seg_real, _ = nets["Seg_de"](ctx["real_f1"])
        l_real = _ce(seg_real, ctx["real_seg_l"])
        l_adv = gan_loss(nets["Dis0_en"](syn_f2), True)
        self._step(state, ("Seg_de",), l_real + self.cfg.df_adv_w * l_adv)
        ctx["metrics"].update(seg_real=l_real.detach(), adv_syn=l_adv.detach())

    def _phase_dep(self, state, ctx):
        nets = state.nets
        with torch.no_grad():
            _, syn_f2 = nets["Seg_de"](ctx["syn_f1"])
        loss = l1_loss(nets["Dep_de"](syn_f2), ctx["syn_dep_l"])
        self._step(state, ("Dep_de",), loss)
        ctx["metrics"]["dep_syn"] = loss.detach()

    def _phase_d(self, state, ctx):
        nets = state.nets
        with torch.no_grad():
            f2s = nets["Seg_de"](nets["G_1"](ctx["syn_img"], "R")[1])[1]
            f2r = nets["Seg_de"](nets["G_2"](ctx["real_img"], "R")[1])[1]
        l_syn = gan_loss(nets["Dis0_en"](f2s), False)
        l_real = gan_loss(nets["Dis0_en"](f2r), True)
        self._step(state, ("Dis0_en",), self.cfg.df_d_real_w * l_real + l_syn)
        ctx["metrics"].update(D_syn=l_syn.detach(), D_real=l_real.detach())

    PHASES = (("G_1", _phase_g1), ("G_2", _phase_g2), ("Seg", _phase_seg),
              ("Dep", _phase_dep), ("D", _phase_d))

    # ------------------------------------------------------------------
    def eval_step(self, state: ModelState, batch
                  ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
        """Eval-mode losses (the real ones where the batch has real labels)
        and the visuals: images, labels, depth and the predictions."""
        return two_trunk_eval(self, state, batch, real_dep=True)


def two_trunk_eval(model, state: ModelState, batch, real_dep: bool):
    """The eval step of S2D_df and S2D_nd: each trunk, Seg_de on its
    features and Dep_de on the depth input Seg_de gives (S2D_df: SEGDF's
    512-channel features; S2D_nd: SEG's input), in eval mode. With
    ``real_dep`` and real labels, ``real_dep_loss`` is reported too."""
    nets = state.nets
    for net in nets.values():
        net.eval()
    f = lambda k: batch[k].to(model.device, torch.float32)  # noqa: E731
    syn_img, real_img, syn_dep_l = f("img_syn"), f("img_real"), f("dep_l_syn")
    syn_seg_l = batch["seg_l_syn"].to(model.device, torch.long)
    with torch.no_grad():
        seg_syn, syn_f2 = nets["Seg_de"](nets["G_1"](syn_img, "R")[1])
        seg_real, real_f2 = nets["Seg_de"](nets["G_2"](real_img, "R")[1])
        dep_syn, dep_real = nets["Dep_de"](syn_f2), nets["Dep_de"](real_f2)
    metrics = {"seg_syn": _ce(seg_syn, syn_seg_l),
               "dep_syn": l1_loss(dep_syn, syn_dep_l),
               "acc_syn": seg_accuracy(seg_syn, syn_seg_l, 255)}
    visuals = dict(syn_img=syn_img, real_img=real_img, syn_seg_l=syn_seg_l,
                   syn_seg_pre=seg_syn.argmax(1),
                   real_seg_pre=seg_real.argmax(1), syn_dep_l=syn_dep_l,
                   syn_dep_pre=dep_syn, real_dep_pre=dep_real)
    if "seg_l_real" in batch:
        real_seg_l = batch["seg_l_real"].to(model.device, torch.long)
        metrics["seg_real"] = _ce(seg_real, real_seg_l)
        metrics["acc_real"] = seg_accuracy(seg_real, real_seg_l, 255)
        if real_dep:
            metrics["dep_real"] = real_dep_loss(seg_real, syn_seg_l,
                                                dep_real, syn_dep_l)
        visuals["real_seg_l"] = real_seg_l
    return model.metrics_dict(**metrics), visuals
