"""S2D, the ``new_multi`` seg+depth domain adaptation (the JAX package's
``models/s2d.py``, reference new_multi/model5.py:194-697).

One train step is the JAX package's four-phase round-robin, in its order:

1. ``g2``, the G_2 update: G_1 on the synthetic image (no gradient), G_2
   ('S') and R_D: the sky-masked depth L1 and the seg CE; G_2 ('R') and R_D
   on the real image: 2 × its seg CE. G_2's outputs of this phase, detached,
   are carried to the later phases;
2. ``g1``, the G_1 update: G_1, G_2 ('S') and R_D afresh, the unmasked depth
   L1 and the seg CE;
3. ``rd_real``, an R_D update on the carried real features: the seg CE and
   0.2 × the LSGAN losses that push FD1–FD3 (in train mode) toward *fake*;
   ``rd_syn``, a second R_D update on the carried synthetic features: the
   sky-masked L1, ``bce_dep_loss`` of each of the four bands, the seg CE;
4. ``fd``, the FD1–FD3 updates: R_D's features of the two phases before,
   detached, real → True, synthetic → False.

Each phase takes its gradient with ``torch.autograd.grad`` over the one net
it updates (the other nets are in its graph), and a parameter that phase
leaves unused gets a zero gradient, so Adam counts its step as optax does.
Adam per net with ``adam_eps``: G_1 lr/5, G_2 lr/3, R_D lr/2, each FD lr/4
(model5.py:250-275), no LR schedule. BatchNorm statistics move in the JAX
forward order: G_1 once in ``g2`` and once in ``g1``, G_2 twice in ``g2``
('S', then 'R') and once in ``g1``, R_D in every phase, the FDs in
``rd_real`` and twice each in ``fd``. The sky is class 17.

For the semantic_trans generation, which subclasses it: the nets come
from ``define_nets`` and each optimizer from ``_optimizer``; ``rd_syn``
scores the bands by ``band_criterion``; ``rd_real`` adds
``rd_real_extra(state, dep_4)`` to its loss; the step context keeps R_D's
detached refined depth and bands of both branches (``real_dep_ref``,
``real_dep_4``, ``syn_dep_ref``, ``syn_dep_4``), and ``_ctx`` takes the
state.

``--dtype bfloat16`` runs every conv in bf16 (parameters and Adam fp32, the
losses fp32); ``--remat`` recomputes the G_2 and R_D applications in
backward (``torch.utils.checkpoint``), their BatchNorm statistics moved
once.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from . import register_model
from ..ops.layers import running_stats_kept, set_compute_dtype
from .base_model import BaseModel, ModelState, make_optimizer
from .networks import gan_loss, l1_loss
from .s2d_networks import bce_dep_loss, define_s2d_nets, get_masks
from .seg_network import cross_entropy_loss, seg_accuracy

LR_DIVISOR = {"G_1": 5, "G_2": 3, "R_D": 2, "FD1": 4, "FD2": 4, "FD3": 4}
FDS = ("FD1", "FD2", "FD3")


@register_model("S2D")
class S2DModel(BaseModel):
    loss_names = ("G1", "G2", "R_D_real", "R_D_syn", "dep_ref", "dep_l1",
                  "dep_band", "seg_syn", "seg_real", "FD", "acc_syn",
                  "acc_real")
    visual_names = ("syn_img", "real_img", "syn_seg_l", "syn_dep_l",
                    "syn_dep_ref", "real_dep_ref", "syn_seg_pre",
                    "real_seg_pre")
    model_names = ("G_1", "G_2", "R_D", "FD1", "FD2", "FD3")
    lr_opt_names = ()

    SKY_CLASS = 17
    define_nets = staticmethod(define_s2d_nets)
    # the per-band depth criterion of ``rd_syn``
    band_criterion = staticmethod(bce_dep_loss)

    def _optimizer(self, name: str, params) -> torch.optim.Optimizer:
        cfg = self.cfg
        return make_optimizer(params, cfg.lr / LR_DIVISOR[name], cfg.beta1,
                              cfg.adam_eps)

    def init_state(self, seed: int = None) -> ModelState:
        """The nets from ``seed`` (default ``cfg.seed``) and one optimizer
        each."""
        cfg = self.cfg
        gen = torch.Generator().manual_seed(cfg.seed if seed is None else seed)
        nets = {k: set_compute_dtype(v.to(self.device), cfg.compute_dtype())
                for k, v in type(self).define_nets(cfg, gen).items()}
        optimizers = {k: self._optimizer(k, nets[k].parameters())
                      for k in self.model_names}
        return ModelState(nets=nets, optimizers=optimizers, pools={})

    # ------------------------------------------------------------------
    def _apply(self, net, *args):
        """``net(*args)``; with ``--remat`` and a gradient to take, through
        ``checkpoint``, its recompute leaving the running statistics as the
        first forward moved them."""
        if not (self.cfg.remat and torch.is_grad_enabled()):
            return net(*args)
        return checkpoint(net, *args, use_reentrant=False, context_fn=lambda: (
            contextlib.nullcontext(), running_stats_kept(net)))

    def _sky(self, seg_l):
        """1 everywhere but the sky class, N1HW."""
        return (seg_l != self.SKY_CLASS).float()[:, None]

    def _step(self, state: ModelState, name: str, loss: torch.Tensor):
        """One Adam step of net ``name`` on ``loss``'s gradient, clipped
        first where ``clip_norms`` names the net."""
        params = list(state.nets[name].parameters())
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        for p, g in zip(params, grads):
            p.grad = torch.zeros_like(p) if g is None else g
        self.optimizer_step(state.optimizers[name],
                            self.clip_norms.get(name))
        for p in params:
            p.grad = None

    def _ctx(self, batch, state: ModelState = None) -> dict:
        """The step context of ``batch`` (``state`` is for subclasses that
        draw from the step)."""
        f = lambda k: batch[k].to(self.device, torch.float32)  # noqa: E731
        lab = lambda k: batch[k].to(self.device, torch.long)   # noqa: E731
        syn_seg_l = lab("seg_l_syn")
        sky = self._sky(syn_seg_l)
        syn_dep_ls = f("depth_l_s")
        sky4 = sky.expand(-1, syn_dep_ls.shape[1], -1, -1)
        oms, zms = get_masks(sky4 * syn_dep_ls)
        return dict(syn_img=f("img_syn"), real_img=f("img_real"),
                    syn_seg_l=syn_seg_l, real_seg_l=lab("seg_l_real"),
                    syn_dep_l=f("dep_l_syn"), syn_dep_ls=syn_dep_ls, sky=sky,
                    sky4=sky4, oms=oms, zms=zms, metrics={})

    # ---- the phases: each updates ``state`` and ``ctx`` in place ----
    def _phase_g2(self, state, ctx):
        nets, m = state.nets, ctx["metrics"]
        with torch.no_grad():
            ss = nets["G_1"](ctx["syn_img"])
        syn_psp, syn_feats = self._apply(nets["G_2"], ss, "S")
        _, seg, (_, dep_o) = self._apply(nets["R_D"], syn_feats, syn_psp)
        dep_loss = l1_loss(dep_o, ctx["sky"] * ctx["syn_dep_l"])
        seg_syn = cross_entropy_loss(seg, ctx["syn_seg_l"], 255)
        real_psp, real_feats = self._apply(nets["G_2"], ctx["real_img"], "R")
        _, seg_r, _ = self._apply(nets["R_D"], real_feats, real_psp)
        seg_real = cross_entropy_loss(seg_r, ctx["real_seg_l"], 255)
        total = dep_loss + seg_syn + 2.0 * seg_real
        self._step(state, "G_2", total)
        m.update(G2=total.detach(), seg_syn=seg_syn.detach(),
                 seg_real=seg_real.detach(),
                 acc_syn=seg_accuracy(seg, ctx["syn_seg_l"], 255),
                 acc_real=seg_accuracy(seg_r, ctx["real_seg_l"], 255))
        ctx.update(syn_psp=syn_psp.detach(), syn_feats=syn_feats,
                   real_psp=real_psp.detach(), real_feats=real_feats)

    def _phase_g1(self, state, ctx):
        nets = state.nets
        h = nets["G_1"](ctx["syn_img"])
        psp, feats = self._apply(nets["G_2"], h, "S")
        _, seg, (_, dep_o) = self._apply(nets["R_D"], feats, psp)
        loss = (l1_loss(dep_o, ctx["syn_dep_l"])
                + cross_entropy_loss(seg, ctx["syn_seg_l"], 255))
        self._step(state, "G_1", loss)
        ctx["metrics"]["G1"] = loss.detach()

    def _phase_rd_real(self, state, ctx):
        nets = state.nets
        feats, seg, (dep_4, dep_o) = self._apply(
            nets["R_D"], ctx["real_feats"], ctx["real_psp"])
        adv = [gan_loss(nets[k](f), False) for k, f in zip(FDS, feats)]
        loss = (cross_entropy_loss(seg, ctx["real_seg_l"], 255)
                + 0.2 * (adv[0] + adv[1] + adv[2])
                + self.rd_real_extra(state, dep_4))
        self._step(state, "R_D", loss)
        ctx["metrics"]["R_D_real"] = loss.detach()
        ctx.update(real_feats_d=[f.detach() for f in feats],
                   real_dep_ref=dep_o.detach(),
                   real_dep_4=[b.detach() for b in dep_4])

    def rd_real_extra(self, state, dep_4):
        """An extra loss of the ``rd_real`` phase on R_D's four band depths:
        none in S2D."""
        return 0.0

    def _phase_rd_syn(self, state, ctx):
        feats, seg, (dep_4, dep_o) = self._apply(
            state.nets["R_D"], ctx["syn_feats"], ctx["syn_psp"])
        sky = ctx["sky"]
        l1_term = l1_loss(dep_o, sky * ctx["syn_dep_l"])
        band_term = torch.zeros((), device=self.device)
        for band in dep_4:
            band_term = band_term + self.band_criterion(
                sky * band, ctx["sky4"] * ctx["syn_dep_ls"], ctx["oms"],
                ctx["zms"])
        dep_loss = l1_term + band_term
        loss = dep_loss + cross_entropy_loss(seg, ctx["syn_seg_l"], 255)
        self._step(state, "R_D", loss)
        ctx["metrics"].update(R_D_syn=loss.detach(), dep_ref=dep_loss.detach(),
                              dep_l1=l1_term.detach(),
                              dep_band=band_term.detach())
        ctx.update(syn_feats_d=[f.detach() for f in feats],
                   syn_dep_ref=dep_o.detach(),
                   syn_dep_4=[b.detach() for b in dep_4])

    def _phase_fd(self, state, ctx):
        total = torch.zeros((), device=self.device)
        for i, name in enumerate(FDS):
            net = state.nets[name]
            loss = (gan_loss(net(ctx["real_feats_d"][i]), True)
                    + gan_loss(net(ctx["syn_feats_d"][i]), False))
            self._step(state, name, loss)
            total = total + loss.detach()
        ctx["metrics"]["FD"] = total

    PHASES = (("g2", _phase_g2), ("g1", _phase_g1), ("rd_real", _phase_rd_real),
              ("rd_syn", _phase_rd_syn), ("fd", _phase_fd))

    # ------------------------------------------------------------------
    def train_step_phased(self, state: ModelState, batch,
                          progress: Optional[Callable[[str], None]] = None
                          ) -> Tuple[ModelState, Dict[str, torch.Tensor]]:
        """The train step, calling ``progress(name)`` after each phase of
        ``PHASES`` (``g2``, ``g1``, ``rd_real``, ``rd_syn``, ``fd``; a
        subclass may add some). ``batch`` holds
        NCHW ``img_syn``/``img_real`` in [-1, 1], ``dep_l_syn`` (N1HW) and
        ``depth_l_s`` (N4HW) in [-1, 1], and NHW ``seg_l_syn``/``seg_l_real``.
        Updates ``state`` in place."""
        for net in state.nets.values():
            net.train()
        ctx = self._ctx(batch, state)
        for name, phase in self.PHASES:
            phase(self, state, ctx)
            if progress is not None:
                progress(name)
        state.step += 1
        m = ctx["metrics"]
        return state, self.metrics_dict(**{k: m[k] for k in self.loss_names})

    def train_step(self, state: ModelState, batch
                   ) -> Tuple[ModelState, Dict[str, torch.Tensor]]:
        return self.train_step_phased(state, batch)

    def eval_step(self, state: ModelState, batch
                  ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
        """Eval-mode losses (the real ones where the batch has real labels)
        and the visuals: images, labels, depth, the refined depth of both
        domains and the predicted label maps."""
        nets = state.nets
        for net in nets.values():
            net.eval()
        f = lambda k: batch[k].to(self.device, torch.float32)  # noqa: E731
        syn_img, real_img = f("img_syn"), f("img_real")
        syn_seg_l = batch["seg_l_syn"].to(self.device, torch.long)
        syn_dep_l = f("dep_l_syn")
        with torch.no_grad():
            syn_psp, syn_feats = nets["G_2"](nets["G_1"](syn_img), "S")
            _, syn_seg, (_, syn_dep_o) = nets["R_D"](syn_feats, syn_psp)
            real_psp, real_feats = nets["G_2"](real_img, "R")
            _, real_seg, (_, real_dep_o) = nets["R_D"](real_feats, real_psp)
        metrics = {
            "seg_syn": cross_entropy_loss(syn_seg, syn_seg_l, 255),
            "dep_ref": l1_loss(syn_dep_o, self._sky(syn_seg_l) * syn_dep_l),
            "acc_syn": seg_accuracy(syn_seg, syn_seg_l, 255)}
        if "seg_l_real" in batch:
            real_seg_l = batch["seg_l_real"].to(self.device, torch.long)
            metrics["seg_real"] = cross_entropy_loss(real_seg, real_seg_l, 255)
            metrics["acc_real"] = seg_accuracy(real_seg, real_seg_l, 255)
        visuals = dict(syn_img=syn_img, real_img=real_img,
                       syn_seg_l=syn_seg_l, syn_dep_l=syn_dep_l,
                       syn_dep_ref=syn_dep_o, real_dep_ref=real_dep_o,
                       syn_seg_pre=syn_seg.argmax(1),
                       real_seg_pre=real_seg.argmax(1))
        return self.metrics_dict(**metrics), visuals
