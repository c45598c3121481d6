"""RefineNet-LW seg+depth training (the JAX package's ``models/rf_lw.py``,
reference new_model/mdoel6.py:199-567 and new_model/model7.py).

``rf_lw``: ResNetLW-101 (G) and four ``segd`` heads that are both seg
decoders and domain discriminators. One train step, in the JAX order:

1. ``g``, the G update, the heads frozen and in eval mode: G on the real
   image, then on the synthetic one (both move G's BatchNorm statistics, in
   that order); every head's nearest-×2 logits pushed toward the true
   labels on both branches; the synthetic depth: 20 × the sky-masked L1 of
   the fused prediction plus ``bce_dep_loss_truncated`` of each band;
2. ``dis``, one update per head (train mode) toward the extra 'fake' class
   on both branches' detached features.

Adam per net (eps 1e-8): G lr/4; seg8 lr/3; seg4, seg2, seg2_0 lr/2; no LR
schedule. The synthetic branch takes the ``_r`` adapters unless
``--syn_domain syn`` (the reference drivers pass no domain); the adapter set
a step leaves unused gets zero gradients, so Adam counts its step as optax
does and leaves it unmoved.

``rf_lw7``: ResNetLW-50, one head (``seg2_0``) and bilinear ×2
(``align_corners=False``). G at lr: 5 × the head's CE on each branch,
total ``g_syn + 3·dep + 2·g_real`` with dep the L1 plus 0.005 × each band's
truncated BCE; then a supervised head update (lr/2) toward the true labels,
``syn + 0.01·real``. ``depth`` (a ``DepthBlockR6``) and its Adam are built
and never stepped, as in the reference. Its depth L1 ×2-upsamples the fused
prediction, as the JAX package does (the reference compares it at half
size, a shape error in torch).

Each phase takes its gradient with ``torch.autograd.grad`` over the one net
it updates. ``--dtype bfloat16`` runs every conv in bf16 (parameters, Adam
and the losses fp32). The sky is class 17.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from . import register_model
from ..ops.layers import resize_bilinear, resize_nearest, set_compute_dtype
from .base_model import BaseModel, ModelState, make_optimizer
from .networks import l1_loss
from .refinenet import HEADS, N_CLS, define_rf_lw_nets, seg_gan_loss
from .s2d_networks import bce_dep_loss_truncated, get_masks
from .seg_network import seg_accuracy


def up2(x: torch.Tensor) -> torch.Tensor:
    """Nearest ×2 (the reference's ``nn.Upsample(scale_factor=2)``)."""
    return resize_nearest(x, (x.shape[2] * 2, x.shape[3] * 2))


def up2b(x: torch.Tensor) -> torch.Tensor:
    """Bilinear ×2, half-pixel centres (model7.py:212)."""
    return resize_bilinear(x, (x.shape[2] * 2, x.shape[3] * 2))


@register_model("rf_lw")
class RefineNetSegDepth(BaseModel):
    loss_names = ("G", "dep_syn", "adv_g_seg_syn", "adv_g_seg_real",
                  "adv_d_seg_syn", "adv_d_seg_real", "acc_syn", "acc_real")
    visual_names = ("syn_img", "real_img", "syn_seg_l", "real_seg_l",
                    "syn_seg_pre", "real_seg_pre", "syn_dep_l", "syn_dep_pre",
                    "real_dep_pre")
    model_names = ("G", "seg8", "seg4", "seg2", "seg2_0")
    lr_opt_names = ()
    LR_DIVISOR = {"G": 4, "seg8": 3, "seg4": 2, "seg2": 2, "seg2_0": 2}

    SKY_CLASS = 17
    HEADS = tuple(HEADS)
    SYN_DOMAIN = "real"
    DEP_W = 20.0  # the weight of the depth L1 in eval_step's dep_syn

    def __init__(self, cfg, device=None):
        super().__init__(cfg, device)
        if cfg.syn_domain is not None:
            if cfg.syn_domain not in ("real", "syn"):
                raise ValueError(
                    f"syn_domain [{cfg.syn_domain}] must be 'real' or 'syn' — "
                    "any other string would silently select the '_s' path")
            self.SYN_DOMAIN = cfg.syn_domain

    def init_state(self, seed: int = None) -> ModelState:
        """The nets from ``seed`` (default ``cfg.seed``) and one Adam each."""
        cfg = self.cfg
        gen = torch.Generator().manual_seed(cfg.seed if seed is None else seed)
        nets = {k: set_compute_dtype(v.to(self.device), cfg.compute_dtype())
                for k, v in define_rf_lw_nets(cfg, gen).items()}
        optimizers = {k: make_optimizer(nets[k].parameters(),
                                        cfg.lr / self.LR_DIVISOR[k], cfg.beta1)
                      for k in self.model_names}
        return ModelState(nets=nets, optimizers=optimizers, pools={})

    # ------------------------------------------------------------------
    def _sky(self, seg_l):
        """1 everywhere but the sky class, N1HW."""
        return (seg_l != self.SKY_CLASS).float()[:, None]

    def _step(self, state: ModelState, name: str, loss: torch.Tensor):
        """One Adam step of net ``name`` on ``loss``'s gradient; a parameter
        the loss does not reach gets a zero gradient."""
        params = list(state.nets[name].parameters())
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        for p, g in zip(params, grads):
            p.grad = torch.zeros_like(p) if g is None else g
        self.optimizer_step(state.optimizers[name])
        for p in params:
            p.grad = None

    def _ctx(self, batch) -> dict:
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

    def _heads(self, nets, feats):
        return [nets[name](feats[HEADS[name][0]]) for name in self.HEADS]

    # ---- the phases: each updates ``state`` and ``ctx`` in place ----
    def _phase_g(self, state, ctx):
        nets = state.nets
        for name in self.HEADS:
            nets[name].eval()
        r_outs, r_pred, r_feats = nets["G"](ctx["real_img"], "real")
        r_heads = self._heads(nets, r_feats)
        g_real = sum(seg_gan_loss(up2(h), ctx["real_seg_l"], True, N_CLS)
                     for h in r_heads)
        s_outs, s_pred, s_feats = nets["G"](ctx["syn_img"], self.SYN_DOMAIN)
        s_heads = self._heads(nets, s_feats)
        g_syn = sum(seg_gan_loss(up2(h), ctx["syn_seg_l"], True, N_CLS)
                    for h in s_heads)
        sky, sky4 = ctx["sky"], ctx["sky4"]
        pred_full = up2(s_pred)
        dep = 20.0 * l1_loss(sky * pred_full, sky * ctx["syn_dep_l"])
        for band in s_outs:
            dep = dep + bce_dep_loss_truncated(
                sky * up2(band), sky4 * ctx["syn_dep_ls"], ctx["oms"],
                ctx["zms"])
        total = g_real + g_syn + dep
        self._step(state, "G", total)
        ctx["metrics"].update(
            G=total.detach(), dep_syn=dep.detach(),
            adv_g_seg_syn=g_syn.detach(), adv_g_seg_real=g_real.detach(),
            acc_syn=seg_accuracy(up2(s_heads[-1]), ctx["syn_seg_l"], 255),
            acc_real=seg_accuracy(up2(r_heads[-1]), ctx["real_seg_l"], 255))
        ctx.update(r_feats=[f.detach() for f in r_feats],
                   s_feats=[f.detach() for f in s_feats])

    def _phase_dis(self, state, ctx):
        adv_real = adv_syn = 0.0
        for name in self.HEADS:
            net, i = state.nets[name], HEADS[name][0]
            net.train()
            l_real = seg_gan_loss(up2(net(ctx["r_feats"][i])),
                                  ctx["real_seg_l"], False, N_CLS)
            l_syn = seg_gan_loss(up2(net(ctx["s_feats"][i])),
                                 ctx["syn_seg_l"], False, N_CLS)
            self._step(state, name, l_real + l_syn)
            adv_real = adv_real + l_real.detach()
            adv_syn = adv_syn + l_syn.detach()
        ctx["metrics"].update(adv_d_seg_syn=adv_syn, adv_d_seg_real=adv_real)

    PHASES = (("g", _phase_g), ("dis", _phase_dis))

    # ------------------------------------------------------------------
    def train_step(self, state: ModelState, batch
                   ) -> Tuple[ModelState, Dict[str, torch.Tensor]]:
        """One step. ``batch`` holds NCHW ``img_syn``/``img_real`` in
        [-1, 1], ``dep_l_syn`` (N1HW) and ``depth_l_s`` (N4HW) in [-1, 1],
        and NHW ``seg_l_syn``/``seg_l_real``. Updates ``state`` in place."""
        state.nets["G"].train()
        ctx = self._ctx(batch)
        for _, phase in self.PHASES:
            phase(self, state, ctx)
        state.step += 1
        m = ctx["metrics"]
        return state, self.metrics_dict(**{k: m[k] for k in self.loss_names})

    def _up(self, x):
        return up2(x)

    def eval_step(self, state: ModelState, batch
                  ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
        """Eval-mode metrics (``acc_real`` where the batch has real labels)
        and the visuals: images, labels, the depth label, the fused depth of
        both domains at full size and the last head's label maps."""
        nets = state.nets
        for net in nets.values():
            net.eval()
        f = lambda k: batch[k].to(self.device, torch.float32)  # noqa: E731
        syn_img, real_img = f("img_syn"), f("img_real")
        syn_seg_l = batch["seg_l_syn"].to(self.device, torch.long)
        syn_dep_l = f("dep_l_syn")
        last = self.HEADS[-1]
        with torch.no_grad():
            _, s_pred, s_feats = nets["G"](syn_img, self.SYN_DOMAIN)
            _, r_pred, r_feats = nets["G"](real_img, "real")
            s_head = self._up(nets[last](s_feats[HEADS[last][0]]))
            r_head = self._up(nets[last](r_feats[HEADS[last][0]]))
            pred_full = self._up(s_pred)
            real_dep = self._up(r_pred)
        metrics = {"dep_syn": self.DEP_W * l1_loss(
            self._sky(syn_seg_l) * pred_full, self._sky(syn_seg_l) * syn_dep_l),
            "acc_syn": seg_accuracy(s_head, syn_seg_l, 255)}
        visuals = dict(syn_img=syn_img, real_img=real_img,
                       syn_seg_l=syn_seg_l, syn_dep_l=syn_dep_l,
                       syn_seg_pre=s_head.argmax(1),
                       real_seg_pre=r_head.argmax(1),
                       syn_dep_pre=pred_full, real_dep_pre=real_dep)
        if "seg_l_real" in batch:
            real_seg_l = batch["seg_l_real"].to(self.device, torch.long)
            metrics["acc_real"] = seg_accuracy(r_head, real_seg_l, 255)
            if "real_seg_l" in self.visual_names:
                visuals["real_seg_l"] = real_seg_l
        return self.metrics_dict(**metrics), visuals


@register_model("rf_lw7")
class RefineNetSegDepth7(RefineNetSegDepth):
    loss_names = ("G", "dep_syn", "adv_g2_0_seg_syn", "adv_g2_0_seg_real",
                  "adv_d2_0_seg_syn", "adv_d2_0_seg_real", "acc_syn",
                  "acc_real")
    visual_names = ("syn_img", "real_img", "syn_seg_l", "syn_seg_pre",
                    "real_seg_pre", "syn_dep_l", "syn_dep_pre",
                    "real_dep_pre")
    model_names = ("G", "seg2_0", "depth")
    LR_DIVISOR = {"G": 1, "seg2_0": 2, "depth": 2}
    HEADS = ("seg2_0",)
    DEP_W = 1.0

    def _up(self, x):
        return up2b(x)

    def _phase_g(self, state, ctx):
        nets = state.nets
        head = nets["seg2_0"]
        head.eval()
        _, r_pred, r_feats = nets["G"](ctx["real_img"], "real")
        r_head = head(r_feats[3])
        g_real = 5.0 * seg_gan_loss(up2b(r_head), ctx["real_seg_l"], True,
                                    N_CLS)
        s_outs, s_pred, s_feats = nets["G"](ctx["syn_img"], self.SYN_DOMAIN)
        s_head = head(s_feats[3])
        g_syn = 5.0 * seg_gan_loss(up2b(s_head), ctx["syn_seg_l"], True, N_CLS)
        sky, sky4 = ctx["sky"], ctx["sky4"]
        dep = l1_loss(sky * up2b(s_pred), sky * ctx["syn_dep_l"])
        for band in s_outs:
            dep = dep + 0.005 * bce_dep_loss_truncated(
                sky * up2b(band), sky4 * ctx["syn_dep_ls"], ctx["oms"],
                ctx["zms"])
        total = g_syn + 3.0 * dep + 2.0 * g_real
        self._step(state, "G", total)
        ctx["metrics"].update(
            G=total.detach(), dep_syn=dep.detach(),
            adv_g2_0_seg_syn=g_syn.detach(), adv_g2_0_seg_real=g_real.detach(),
            acc_syn=seg_accuracy(up2b(s_head), ctx["syn_seg_l"], 255),
            acc_real=seg_accuracy(up2b(r_head), ctx["real_seg_l"], 255))
        ctx.update(r_feats=[r_feats[3].detach()], s_feats=[s_feats[3].detach()])

    def _phase_dis(self, state, ctx):
        head = state.nets["seg2_0"]
        head.train()
        l_real = seg_gan_loss(up2b(head(ctx["r_feats"][0])), ctx["real_seg_l"],
                              True, N_CLS)
        l_syn = seg_gan_loss(up2b(head(ctx["s_feats"][0])), ctx["syn_seg_l"],
                             True, N_CLS)
        self._step(state, "seg2_0", l_syn + 0.01 * l_real)
        ctx["metrics"].update(adv_d2_0_seg_syn=l_syn.detach(),
                              adv_d2_0_seg_real=l_real.detach())

    PHASES = (("g", _phase_g), ("dis", _phase_dis))
