"""S2D_base, the base my_seg_depth generation (the JAX package's
``models/s2d_base.py``, reference my_seg_depth/model2.py:206-401).

Nets: G_1 (``G1`` with standard ResnetBlocks), G_2 (``GeneralNet2``), the
skip decoders Seg_de (``SEG2``, 28 classes, CE weighted by
``CLASS_WEIGHTS_28``) and Dep_de (``DEP2``), and Dis_en
(``DropDiscriminator``), which aligns G_1's synthetic features with the
real stem features. One train step, in the JAX step's order:

1. G_2 ('R') on the real image, without gradient: its features, detached,
   feed the later phases (G_2's statistics move: R);
2. ``G``: G_1 ← LSGAN(Dis_en(G_1(syn)), real); G_2 ← the weighted CE of
   Seg_de on G_2('S') of G_1's detached features and on G_2('R') of the
   real image (statistics S, R); one gradient of the sum over G_1 and G_2,
   an Adam step each;
3. G_2 ('S') again on G_1's features, with G_2's new weights and no
   gradient (statistics S);
4. ``Seg``: Seg_de ← 5 × CE(real) + CE(syn);
5. ``Dep``: Dep_de ← L1 of the synthetic depth;
6. ``D``: Dis_en ← LSGAN, G_1's synthetic features → fake, the real stem
   features → real.

G_2's statistics thus move R, S, R, S, as in the JAX step (the reference's
eager loop moves them R, S, R, S, S). Dis_en's Dropout2d is live in every
training forward (the reference never switches it to eval): the three
forwards of a step each draw their keep-masks from a CPU
``torch.Generator`` seeded by ``seed`` and the step, so the card and the
CPU draw the same masks and a resumed run draws what the run would have.
With ``--dis_seg`` Dis_en is conditioned on the label maps (the synthetic
one in ``G``, each branch's own in ``D``). Each phase takes its gradient
with ``torch.autograd.grad`` over the nets it updates, an unused parameter
(G_2's ``conv0`` in mode 'S') getting a zero gradient so that Adam counts
its step as optax does. Adam at ``lr`` and eps 1e-8 for every net, no LR
schedule. Under ``--parallel sp`` the nets run on this rank's rows
(``parallel/spatial_s2d.py``), Dis_en's keep-masks are the same on every
``model`` rank, the means are global and ``eval_step`` gathers the
visuals' rows.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from . import register_model
from ..ops.layers import set_compute_dtype
from ..parallel.collectives import gather_spatial, global_rows, local_rows
from .base_model import BaseModel, ModelState, make_optimizer
from .networks import gan_loss, l1_loss
from .s2d_networks import CLASS_WEIGHTS_28, define_s2d_base_nets
from .seg_network import cross_entropy_loss, seg_accuracy


class PhasedModel(BaseModel):
    """What the base and the two-trunk S2D generations share: the nets from
    one seed, an optimizer per net (Adam unless ``_optimizer`` says
    otherwise) and a train step of named ``PHASES``."""

    define_nets: Callable = None
    PHASES: Tuple = ()

    def _lr(self, name: str) -> float:
        return self.cfg.lr

    def _optimizer(self, name: str, params) -> torch.optim.Optimizer:
        return make_optimizer(params, self._lr(name), self.cfg.beta1)

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

    def _step(self, state: ModelState, names, loss: torch.Tensor):
        """One optimizer step of each net of ``names`` on ``loss``'s
        gradient; a parameter ``loss`` does not reach gets a zero one, so
        that Adam counts the step as optax does. A net of ``clip_norms``
        has its gradient clipped first."""
        params = [list(state.nets[k].parameters()) for k in names]
        grads = torch.autograd.grad(loss, [p for ps in params for p in ps],
                                    allow_unused=True)
        it = iter(grads)
        for name, ps in zip(names, params):
            for p in ps:
                g = next(it)
                p.grad = torch.zeros_like(p) if g is None else g
            self.optimizer_step(state.optimizers[name],
                                self.clip_norms.get(name))
            for p in ps:
                p.grad = None

    def _ctx(self, state: ModelState, batch) -> dict:
        f = lambda k: batch[k].to(self.device, torch.float32)  # noqa: E731
        lab = lambda k: batch[k].to(self.device, torch.long)   # noqa: E731
        return dict(syn_img=f("img_syn"), real_img=f("img_real"),
                    syn_seg_l=lab("seg_l_syn"), real_seg_l=lab("seg_l_real"),
                    syn_dep_l=f("dep_l_syn"), metrics={})

    def train_step_phased(self, state: ModelState, batch,
                          progress: Optional[Callable[[str], None]] = None
                          ) -> Tuple[ModelState, Dict[str, torch.Tensor]]:
        """The train step, calling ``progress(name)`` after each phase.
        ``batch`` holds NCHW ``img_syn``/``img_real`` in [-1, 1],
        ``dep_l_syn`` (N1HW) in [-1, 1] and NHW ``seg_l_syn``/
        ``seg_l_real``. Updates ``state`` in place."""
        for net in state.nets.values():
            net.train()
        ctx = self._ctx(state, batch)
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


class DropMaskModel(PhasedModel):
    """A ``PhasedModel`` whose Dis_en has live dropout: the step context's
    ``masks`` gives each Dis_en forward its keep-masks."""

    def dropout_masks(self, state: ModelState, n: int):
        """A function that returns the next Dis_en forward's keep-masks for
        a batch of ``n``, drawn on the CPU from ``step_generator``; under
        data parallelism drawn for the global batch, this rank's rows
        kept."""
        gen = self.step_generator(state)
        dis = state.nets["Dis_en"]
        return lambda: [local_rows(m).to(self.device)
                        for m in dis.draw_masks(global_rows(n), gen)]

    def _ctx(self, state, batch):
        ctx = super()._ctx(state, batch)
        ctx["masks"] = self.dropout_masks(state, ctx["syn_img"].shape[0])
        return ctx


@register_model("S2D_base")
class S2DBaseModel(DropMaskModel):
    loss_names = ("G1_dis", "D_syn", "seg_syn", "seg_real", "D_real",
                  "dep_syn", "acc_syn", "acc_real")
    visual_names = ("syn_img", "real_img", "syn_seg_l", "real_seg_l",
                    "syn_seg_pre", "real_seg_pre", "syn_dep_l", "syn_dep_pre")
    model_names = ("G_1", "G_2", "Dis_en", "Seg_de", "Dep_de")
    lr_opt_names = ()
    define_nets = staticmethod(define_s2d_base_nets)

    def _ce(self, logits, labels):
        w = torch.tensor(CLASS_WEIGHTS_28, device=self.device)
        return cross_entropy_loss(logits, labels, 255, w)

    def _ctx(self, state, batch):
        ctx = super()._ctx(state, batch)
        for d in ("syn", "real"):  # Dis_en's label maps with --dis_seg
            ctx[f"{d}_sege"] = (ctx[f"{d}_seg_l"].float()[:, None]
                                if self.cfg.dis_seg else None)
        return ctx

    # ---- the phases: each updates ``state`` and ``ctx`` in place ----
    def _phase_real(self, state, ctx):
        with torch.no_grad():
            feats, psp = state.nets["G_2"](ctx["real_img"], "R")
        ctx.update(real_feats=feats, real_psp=psp)

    def _phase_g(self, state, ctx):
        nets, m = state.nets, ctx["metrics"]
        f1 = nets["G_1"](ctx["syn_img"])
        loss_g1 = gan_loss(nets["Dis_en"](f1, ctx["syn_sege"],
                                          masks=ctx["masks"]()), True)
        syn_f2, syn_psp = nets["G_2"](f1.detach(), "S")
        seg_syn = nets["Seg_de"](syn_f2, syn_psp)
        real_f2, real_psp = nets["G_2"](ctx["real_img"], "R")
        seg_real = nets["Seg_de"](real_f2, real_psp)
        total = (loss_g1 + self._ce(seg_syn, ctx["syn_seg_l"])
                 + self._ce(seg_real, ctx["real_seg_l"]))
        self._step(state, ("G_1", "G_2"), total)
        m.update(G1_dis=loss_g1.detach(),
                 acc_syn=seg_accuracy(seg_syn, ctx["syn_seg_l"], 255),
                 acc_real=seg_accuracy(seg_real, ctx["real_seg_l"], 255))
        ctx["syn_f1"] = f1.detach()

    def _phase_frozen(self, state, ctx):
        with torch.no_grad():
            feats, psp = state.nets["G_2"](ctx["syn_f1"], "S")
        ctx.update(syn_feats=feats, syn_psp=psp)

    def _phase_seg(self, state, ctx):
        net = state.nets["Seg_de"]
        l_syn = self._ce(net(ctx["syn_feats"], ctx["syn_psp"]),
                         ctx["syn_seg_l"])
        l_real = self._ce(net(ctx["real_feats"], ctx["real_psp"]),
                          ctx["real_seg_l"])
        self._step(state, ("Seg_de",), 5.0 * l_real + l_syn)
        ctx["metrics"].update(seg_syn=l_syn.detach(), seg_real=l_real.detach())

    def _phase_dep(self, state, ctx):
        pred = state.nets["Dep_de"](ctx["syn_feats"], ctx["syn_psp"])
        loss = l1_loss(pred, ctx["syn_dep_l"])
        self._step(state, ("Dep_de",), loss)
        ctx["metrics"]["dep_syn"] = loss.detach()

    def _phase_d(self, state, ctx):
        net = state.nets["Dis_en"]
        l_syn = gan_loss(net(ctx["syn_f1"], ctx["syn_sege"],
                             masks=ctx["masks"]()), False)
        l_real = gan_loss(net(ctx["real_feats"][0], ctx["real_sege"],
                              masks=ctx["masks"]()), True)
        self._step(state, ("Dis_en",), l_syn + l_real)
        ctx["metrics"].update(D_syn=l_syn.detach(), D_real=l_real.detach())

    PHASES = (("real", _phase_real), ("G", _phase_g),
              ("frozen", _phase_frozen), ("Seg", _phase_seg),
              ("Dep", _phase_dep), ("D", _phase_d))

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
            syn_f2, syn_psp = nets["G_2"](nets["G_1"](syn_img), "S")
            real_f2, real_psp = nets["G_2"](real_img, "R")
            seg_syn = nets["Seg_de"](syn_f2, syn_psp)
            seg_real = nets["Seg_de"](real_f2, real_psp)
            dep = nets["Dep_de"](syn_f2, syn_psp)
        metrics = {"seg_syn": self._ce(seg_syn, syn_seg_l),
                   "dep_syn": l1_loss(dep, syn_dep_l),
                   "acc_syn": seg_accuracy(seg_syn, syn_seg_l, 255)}
        visuals = dict(syn_img=syn_img, real_img=real_img,
                       syn_seg_l=syn_seg_l, syn_seg_pre=seg_syn.argmax(1),
                       real_seg_pre=seg_real.argmax(1), syn_dep_l=syn_dep_l,
                       syn_dep_pre=dep)
        if "seg_l_real" in batch:
            real_seg_l = batch["seg_l_real"].to(self.device, torch.long)
            metrics["seg_real"] = self._ce(seg_real, real_seg_l)
            metrics["acc_real"] = seg_accuracy(seg_real, real_seg_l, 255)
            visuals["real_seg_l"] = real_seg_l
        visuals = {k: gather_spatial(v) for k, v in visuals.items()}
        return self.metrics_dict(**metrics), visuals
