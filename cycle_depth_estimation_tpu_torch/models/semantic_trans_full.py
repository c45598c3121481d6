"""semantic_trans_full, the trymulti/semantic_trans generation's own
pipeline (the JAX package's ``models/semantic_trans_full.py``, reference
my_seg_depth/trymulti/semantic_trans/model5.py:194-790).

Nets: G_1 (``G1``), G_2 (``GeneralNet`` at the JAX defaults: mid 1024,
growth 32, ``dense_block_config`` from the config), Seg_de (``SEG``, 28
classes) and Dep_de (``DEP``) over G_2's PSP output, both at slope 0.02,
R_D (``RDepST``), Dis0_en (``Discriminator2Seg`` over Seg_de's input) and
the four ``StarDiscriminator`` critics DIS, Dis_80, Dis_160 and Dis_320.
One train step, seven phases in the JAX step's order:

1. ``G_1``: G_1 ← CE(Seg_de(G_2('S', G_1(syn)))) + 3 × LSGAN(Dis0_en(the
   same features), real);
2. ``G_2``: G_2 ← CE(real seg) + CE(syn seg on G_1's detached output) + 5
   × LSGAN(Dis0_en(syn features), real); Dep_de runs on the detached real
   features for its statistics alone. G_2's outputs of this phase,
   detached, are carried to the later phases;
3. ``Seg``: Seg_de ← CE(real) + LSGAN(Dis0_en(syn features), real) on
   detached features: that term has a value and no gradient, as in the
   reference; the syn forward moves the statistics;
4. ``Dep``: Dep_de ← L1 of the syn depth;
5. ``R_D_real``: R_D ← the edge BCE of its three (edge, depth) pairs
   accumulated as the reference does (``se = se + se + bce``: weights 4, 2,
   1) and counted twice, + the last scale's CE, + 0.2 · LSGAN(Dis_160(band
   1 of pair 0 at 1/4), fake) + LSGAN(Dis_320(band 1 of pair 1 at 1/2),
   fake);
6. ``R_D_syn``: R_D ← Σ edge BCE + Σ seg CE + 10 × L1 of the full-size
   depth;
7. ``D``: Dis0_en ← LSGAN on fresh forwards (G_1, G_2 'S', Seg_de, G_2
   'R', Seg_de; syn → fake, real → real); DIS ← LSGAN on the (depth,
   label) pairs of phases 5 and 6 (real → real, syn → fake; no penalty, as
   in the JAX step); Dis_160 and Dis_320 ← LSGAN on those phases' band-1
   maps, each gradient clipped to global norm 1 by optax's rule first. The
   ``d160_syn``/``d320_syn`` reports score the syn side against the
   *real* target, as the reference logs them. Dis_80 is built, saved and
   given an optimizer, and never stepped.

The edge BCE is ``F.binary_cross_entropy`` on the sigmoid edge maps
against the ``try`` loader's ``seg_e_*`` maps. Each phase takes its
gradient over the one net it updates, a parameter it leaves unused (G_2's
stem in mode 'S', R_D's band heads and level-0 outputs) getting a zero
one. BatchNorm statistics move as in the JAX step: G_1 ×3, G_2 ×5,
Seg_de ×7, Dep_de ×2, R_D ×2 and Dis0_en ×5 a step. Adam at eps 1e-8
whatever ``adam_eps`` says: lr/2 for G_1, G_2, Seg_de, Dep_de, R_D and
Dis0_en, lr/4 for the four critics; no LR schedule and no ``--remat``, as
in the JAX model.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from . import register_model
from .base_model import ModelState
from .networks import gan_loss, l1_loss
from .s2d_base import PhasedModel
from .s2d_networks import define_semantic_trans_full_nets
from .semantic_trans import CRITICS, depth_label_pair, downscaled
from .seg_network import cross_entropy_loss, seg_accuracy


def _ce(logits, labels):
    return cross_entropy_loss(logits, labels, 255)


def _bce(p, t):
    return F.binary_cross_entropy(p.float(), t.float())


def band1(sed: torch.Tensor, factor: int) -> torch.Tensor:
    """The depth channel of an (edge, depth) pair at 1/``factor`` of its
    size."""
    return downscaled(sed[:, 1:2], factor)


@register_model("semantic_trans_full")
class SemanticTransFull(PhasedModel):
    loss_names = ("G1", "G2", "seg_real", "dep_syn", "R_D_real", "R_D_syn",
                  "dep_ref", "D_real", "D_syn", "DEP_real", "DEP_syn",
                  "d160_real", "d160_syn", "d320_real", "d320_syn",
                  "acc_syn", "acc_real")
    visual_names = ("syn_img", "real_img", "syn_seg_l", "syn_seg_pre",
                    "real_seg_pre", "syn_dep_l", "syn_dep_pre",
                    "real_dep_pre", "syn_dep_ref", "real_dep_ref")
    model_names = ("G_1", "G_2", "Seg_de", "Dep_de", "R_D", "Dis0_en",
                   *CRITICS)
    lr_opt_names = ()
    define_nets = staticmethod(define_semantic_trans_full_nets)
    clip_norms = {"Dis_160": 1.0, "Dis_320": 1.0}

    def _lr(self, name):
        return self.cfg.lr / (4 if name in CRITICS else 2)

    def _ctx(self, state, batch):
        """``PhasedModel``'s context and the NHW edge maps ``syn_seg_le``/
        ``real_seg_le`` of the batch's N1HW ``seg_e_syn``/``seg_e_real``."""
        ctx = super()._ctx(state, batch)
        for d in ("syn", "real"):
            ctx[f"{d}_seg_le"] = batch[f"seg_e_{d}"].to(self.device,
                                                       torch.float32)[:, 0]
        return ctx

    # ---- the phases: each updates ``state`` and ``ctx`` in place ----
    def _phase_g1(self, state, ctx):
        nets = state.nets
        f1, _ = nets["G_2"](nets["G_1"](ctx["syn_img"]), "S")
        seg, f2 = nets["Seg_de"](f1)
        loss = (_ce(seg, ctx["syn_seg_l"])
                + 3.0 * gan_loss(nets["Dis0_en"](f2), True))
        self._step(state, ("G_1",), loss)
        ctx["metrics"]["G1"] = loss.detach()

    def _phase_g2(self, state, ctx):
        nets, m = state.nets, ctx["metrics"]
        with torch.no_grad():
            ss = nets["G_1"](ctx["syn_img"])
        rf1, r_feats = nets["G_2"](ctx["real_img"], "R")
        seg_r, rf2 = nets["Seg_de"](rf1)
        with torch.no_grad():  # the reference's visual forward
            nets["Dep_de"](rf2)
        sf1, s_feats = nets["G_2"](ss, "S")
        seg_s, sf2 = nets["Seg_de"](sf1)
        loss = (_ce(seg_r, ctx["real_seg_l"]) + _ce(seg_s, ctx["syn_seg_l"])
                + 5.0 * gan_loss(nets["Dis0_en"](sf2), True))
        self._step(state, ("G_2",), loss)
        m.update(G2=loss.detach(),
                 acc_syn=seg_accuracy(seg_s, ctx["syn_seg_l"], 255),
                 acc_real=seg_accuracy(seg_r, ctx["real_seg_l"], 255))
        ctx.update(syn_f1=sf1.detach(), syn_feats=s_feats,
                   real_f1=rf1.detach(), real_feats=r_feats)

    def _phase_seg(self, state, ctx):
        nets = state.nets
        with torch.no_grad():
            _, f2s = nets["Seg_de"](ctx["syn_f1"])
        seg_r, _ = nets["Seg_de"](ctx["real_f1"])
        l_real = _ce(seg_r, ctx["real_seg_l"])
        with torch.no_grad():
            adv = gan_loss(nets["Dis0_en"](f2s), True)
        self._step(state, ("Seg_de",), l_real + adv)
        ctx["metrics"]["seg_real"] = l_real.detach()

    def _phase_dep(self, state, ctx):
        loss = l1_loss(state.nets["Dep_de"](ctx["syn_f1"]), ctx["syn_dep_l"])
        self._step(state, ("Dep_de",), loss)
        ctx["metrics"]["dep_syn"] = loss.detach()

    def _phase_rd_real(self, state, ctx):
        nets = state.nets
        seds, segs, _ = nets["R_D"](ctx["real_feats"], ctx["real_f1"])
        se = 0.0
        for sed in seds:
            se = se + se + _bce(sed[:, 0], ctx["real_seg_le"])
        seg_loss = se + _ce(segs[2], ctx["real_seg_l"])
        b160, b320 = band1(seds[0], 4), band1(seds[1], 2)
        loss = (se + seg_loss + 0.2 * gan_loss(nets["Dis_160"](b160), False)
                + gan_loss(nets["Dis_320"](b320), False))
        self._step(state, ("R_D",), loss)
        ctx["metrics"]["R_D_real"] = loss.detach()
        ctx.update(real_dep_ref=band1(seds[2], 1).detach(),
                   real_dep_160=b160.detach(), real_dep_320=b320.detach())

    def _phase_rd_syn(self, state, ctx):
        seds, segs, _ = state.nets["R_D"](ctx["syn_feats"], ctx["syn_f1"])
        se = seg = 0.0
        for sed in seds:
            se = se + _bce(sed[:, 0], ctx["syn_seg_le"])
        for s in segs:
            seg = seg + _ce(s, ctx["syn_seg_l"])
        dep_ref = l1_loss(band1(seds[2], 1), ctx["syn_dep_l"])
        loss = 10.0 * dep_ref + se + seg
        self._step(state, ("R_D",), loss)
        ctx["metrics"].update(R_D_syn=loss.detach(), dep_ref=dep_ref.detach())
        with torch.no_grad():
            ctx.update(syn_dep_ref=band1(seds[2], 1).detach(),
                       syn_dep_160=band1(seds[0], 4),
                       syn_dep_320=band1(seds[1], 2))

    def _phase_d(self, state, ctx):
        nets, m = state.nets, ctx["metrics"]
        with torch.no_grad():
            sf2 = nets["Seg_de"](nets["G_2"](nets["G_1"](ctx["syn_img"]),
                                             "S")[0])[1]
            rf2 = nets["Seg_de"](nets["G_2"](ctx["real_img"], "R")[0])[1]
        d0 = nets["Dis0_en"]
        l_syn = gan_loss(d0(sf2), False)
        l_real = gan_loss(d0(rf2), True)
        self._step(state, ("Dis0_en",), l_real + l_syn)
        m.update(D_real=l_real.detach(), D_syn=l_syn.detach())
        dis = nets["DIS"]
        l_real = gan_loss(dis(depth_label_pair(ctx["real_dep_ref"],
                                               ctx["real_seg_l"])), True)
        l_syn = gan_loss(dis(depth_label_pair(ctx["syn_dep_ref"],
                                              ctx["syn_seg_l"])), False)
        self._step(state, ("DIS",), l_real + l_syn)
        m.update(DEP_real=l_real.detach(), DEP_syn=l_syn.detach())
        for name, key in (("Dis_160", "160"), ("Dis_320", "320")):
            net = nets[name]
            pr = net(ctx[f"real_dep_{key}"])
            pf = net(ctx[f"syn_dep_{key}"])
            self._step(state, (name,), gan_loss(pr, True) + gan_loss(pf, False))
            m.update({f"d{key}_real": gan_loss(pr, True).detach(),
                      f"d{key}_syn": gan_loss(pf, True).detach()})

    PHASES = (("G_1", _phase_g1), ("G_2", _phase_g2), ("Seg", _phase_seg),
              ("Dep", _phase_dep), ("R_D_real", _phase_rd_real),
              ("R_D_syn", _phase_rd_syn), ("D", _phase_d))

    # ------------------------------------------------------------------
    def eval_step(self, state: ModelState, batch
                  ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
        """Eval-mode losses (the real ones where the batch has real labels)
        and the visuals: images, labels, the decoders' depth and label
        maps, and R_D's full-size depth of both domains."""
        nets = state.nets
        for net in nets.values():
            net.eval()
        f = lambda k: batch[k].to(self.device, torch.float32)  # noqa: E731
        syn_img, real_img, syn_dep_l = f("img_syn"), f("img_real"), \
            f("dep_l_syn")
        syn_seg_l = batch["seg_l_syn"].to(self.device, torch.long)
        with torch.no_grad():
            sf1, s_feats = nets["G_2"](nets["G_1"](syn_img), "S")
            rf1, r_feats = nets["G_2"](real_img, "R")
            seg_s, seg_r = nets["Seg_de"](sf1)[0], nets["Seg_de"](rf1)[0]
            dep_s, dep_r = nets["Dep_de"](sf1), nets["Dep_de"](rf1)
            ref_s = band1(nets["R_D"](s_feats, sf1)[0][2], 1)
            ref_r = band1(nets["R_D"](r_feats, rf1)[0][2], 1)
        metrics = {"seg_syn": _ce(seg_s, syn_seg_l),
                   "dep_syn": l1_loss(dep_s, syn_dep_l),
                   "dep_ref": l1_loss(ref_s, syn_dep_l),
                   "acc_syn": seg_accuracy(seg_s, syn_seg_l, 255)}
        if "seg_l_real" in batch:
            real_seg_l = batch["seg_l_real"].to(self.device, torch.long)
            metrics["seg_real"] = _ce(seg_r, real_seg_l)
            metrics["acc_real"] = seg_accuracy(seg_r, real_seg_l, 255)
        visuals = dict(syn_img=syn_img, real_img=real_img,
                       syn_seg_l=syn_seg_l, syn_dep_l=syn_dep_l,
                       syn_seg_pre=seg_s.argmax(1),
                       real_seg_pre=seg_r.argmax(1), syn_dep_pre=dep_s,
                       real_dep_pre=dep_r, syn_dep_ref=ref_s,
                       real_dep_ref=ref_r)
        return self.metrics_dict(**metrics), visuals
