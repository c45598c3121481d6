"""S2D_alt, the base generation's alternate Feature_net pipeline (the JAX
package's ``models/s2d_alt.py``, reference my_seg_depth/train.py:221-409).

Two BatchNorm encoders (``GBase``: G_1 for the synthetic image, G_2 for the
real one) map both domains to 128 channels at 1/4 of the image; Dis_en
(``DropDiscriminator``) aligns them there; ``FeatureNet`` and its PSP head
feed the skip decoders Seg_de (``SEGAlt``, tanh) and Dep_de (``DEPAlt``).
One train step, five phases in the JAX step's order:

1. ``G``: G_1 ← LSGAN(Dis_en(syn), real) + CE(seg of syn); G_2 ←
   LSGAN(Dis_en(real), fake) + CE(seg of real), through Feature and Seg_de
   (not updated); one gradient of the sum over G_1 and G_2, an Adam step
   each. The encoders' outputs, detached, feed the later phases;
2. ``Feature``: 5 × (CE(syn) + CE(real)) + L1(depth) through fresh Feature
   forwards (syn, real, then syn again for the depth), the PSP output
   detached where it enters the decoders (the reference's ``inf.detach()``,
   train.py:312-313,321), so the PSP head gets a zero gradient;
3. ``Seg``: Seg_de ← CE(syn) + CE(real) on fresh Feature forwards;
4. ``Dep``: Dep_de ← L1 on a fresh Feature forward;
5. ``D``: Dis_en ← LSGAN, syn → fake, real → real.

The CE is unweighted, on Seg_de's tanh outputs (the reference's). Feature's
BatchNorm statistics move in every phase (2, 3, 2, 1 forwards), G_1's and
G_2's once, in phase 1. Dis_en's Dropout2d is live in all four of its
forwards, each with keep-masks drawn as S2D_base draws them
(``DropMaskModel``). Adam at ``lr``, Dis_en at ``lr_d``; eps 1e-8.
Under ``--parallel sp`` the six nets run on this rank's rows
(``parallel/spatial_s2d.py``), as S2D_base's do.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from . import register_model
from ..parallel.collectives import gather_spatial
from .base_model import ModelState
from .networks import gan_loss, l1_loss
from .s2d_base import DropMaskModel
from .s2d_networks import define_s2d_alt_nets
from .seg_network import cross_entropy_loss, seg_accuracy


def _ce(logits, labels):
    return cross_entropy_loss(logits, labels, 255)


@register_model("S2D_alt")
class S2DAltModel(DropMaskModel):
    loss_names = ("G1_dis", "G1_seg", "D_G1", "G2_dis", "G2_seg", "D_G2",
                  "seg_syn", "seg_real", "dep_syn", "acc_syn", "acc_real")
    visual_names = ("syn_img", "real_img", "syn_seg_l", "real_seg_l",
                    "syn_seg_pre", "real_seg_pre", "syn_dep_l", "syn_dep_pre")
    model_names = ("G_1", "G_2", "Dis_en", "Feature", "Seg_de", "Dep_de")
    lr_opt_names = ()
    define_nets = staticmethod(define_s2d_alt_nets)

    def _lr(self, name):
        return self.cfg.lr_d if name == "Dis_en" else self.cfg.lr

    # ---- the phases: each updates ``state`` and ``ctx`` in place ----
    def _phase_g(self, state, ctx):
        nets, m = state.nets, ctx["metrics"]
        sf1 = nets["G_1"](ctx["syn_img"])
        rf1 = nets["G_2"](ctx["real_img"])
        g1_dis = gan_loss(nets["Dis_en"](sf1, masks=ctx["masks"]()), True)
        g2_dis = gan_loss(nets["Dis_en"](rf1, masks=ctx["masks"]()), False)
        s_feats, s_psp = nets["Feature"](sf1)
        r_feats, r_psp = nets["Feature"](rf1)
        g1_seg = _ce(nets["Seg_de"](s_feats, s_psp), ctx["syn_seg_l"])
        g2_seg = _ce(nets["Seg_de"](r_feats, r_psp), ctx["real_seg_l"])
        self._step(state, ("G_1", "G_2"), g1_dis + g1_seg + g2_dis + g2_seg)
        m.update(G1_dis=g1_dis.detach(), G2_dis=g2_dis.detach(),
                 G1_seg=g1_seg.detach(), G2_seg=g2_seg.detach())
        ctx.update(sf1=sf1.detach(), rf1=rf1.detach())

    def _phase_feature(self, state, ctx):
        nets = state.nets
        feature, seg = nets["Feature"], nets["Seg_de"]
        s_feats, s_psp = feature(ctx["sf1"])
        r_feats, r_psp = feature(ctx["rf1"])
        loss_s = (_ce(seg(s_feats, s_psp.detach()), ctx["syn_seg_l"])
                  + _ce(seg(r_feats, r_psp.detach()), ctx["real_seg_l"]))
        d_feats, d_psp = feature(ctx["sf1"])
        loss_d = l1_loss(nets["Dep_de"](d_feats, d_psp.detach()),
                         ctx["syn_dep_l"])
        self._step(state, ("Feature",), 5.0 * loss_s + loss_d)

    def _phase_seg(self, state, ctx):
        nets = state.nets
        with torch.no_grad():
            s_in = nets["Feature"](ctx["sf1"])
            r_in = nets["Feature"](ctx["rf1"])
        seg_s, seg_r = nets["Seg_de"](*s_in), nets["Seg_de"](*r_in)
        l_syn, l_real = _ce(seg_s, ctx["syn_seg_l"]), _ce(seg_r,
                                                          ctx["real_seg_l"])
        self._step(state, ("Seg_de",), l_syn + l_real)
        ctx["metrics"].update(
            seg_syn=l_syn.detach(), seg_real=l_real.detach(),
            acc_syn=seg_accuracy(seg_s, ctx["syn_seg_l"], 255),
            acc_real=seg_accuracy(seg_r, ctx["real_seg_l"], 255))

    def _phase_dep(self, state, ctx):
        nets = state.nets
        with torch.no_grad():
            s_in = nets["Feature"](ctx["sf1"])
        loss = l1_loss(nets["Dep_de"](*s_in), ctx["syn_dep_l"])
        self._step(state, ("Dep_de",), loss)
        ctx["metrics"]["dep_syn"] = loss.detach()

    def _phase_d(self, state, ctx):
        net = state.nets["Dis_en"]
        d_g1 = gan_loss(net(ctx["sf1"], masks=ctx["masks"]()), False)
        d_g2 = gan_loss(net(ctx["rf1"], masks=ctx["masks"]()), True)
        self._step(state, ("Dis_en",), d_g1 + d_g2)
        ctx["metrics"].update(D_G1=d_g1.detach(), D_G2=d_g2.detach())

    PHASES = (("G", _phase_g), ("Feature", _phase_feature),
              ("Seg", _phase_seg), ("Dep", _phase_dep), ("D", _phase_d))

    # ------------------------------------------------------------------
    def eval_step(self, state: ModelState, batch
                  ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
        """Eval-mode losses (the real ones where the batch has real labels)
        and the visuals: images, labels, depth and the predictions."""
        nets = state.nets
        for net in nets.values():
            net.eval()
        f = lambda k: batch[k].to(self.device, torch.float32)  # noqa: E731
        syn_img, real_img, syn_dep_l = f("img_syn"), f("img_real"), \
            f("dep_l_syn")
        syn_seg_l = batch["seg_l_syn"].to(self.device, torch.long)
        with torch.no_grad():
            s_in = nets["Feature"](nets["G_1"](syn_img))
            r_in = nets["Feature"](nets["G_2"](real_img))
            seg_s, seg_r = nets["Seg_de"](*s_in), nets["Seg_de"](*r_in)
            dep = nets["Dep_de"](*s_in)
        metrics = {"seg_syn": _ce(seg_s, syn_seg_l),
                   "dep_syn": l1_loss(dep, syn_dep_l),
                   "acc_syn": seg_accuracy(seg_s, syn_seg_l, 255)}
        visuals = dict(syn_img=syn_img, real_img=real_img,
                       syn_seg_l=syn_seg_l, syn_dep_l=syn_dep_l,
                       syn_seg_pre=seg_s.argmax(1),
                       real_seg_pre=seg_r.argmax(1), syn_dep_pre=dep)
        if "seg_l_real" in batch:
            real_seg_l = batch["seg_l_real"].to(self.device, torch.long)
            metrics["seg_real"] = _ce(seg_r, real_seg_l)
            metrics["acc_real"] = seg_accuracy(seg_r, real_seg_l, 255)
            visuals["real_seg_l"] = real_seg_l
        visuals = {k: gather_spatial(v) for k, v in visuals.items()}
        return self.metrics_dict(**metrics), visuals
