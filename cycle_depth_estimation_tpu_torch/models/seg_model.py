"""T2Net (``--model seg``): a frozen synthetic→real ResnetGenerator and a
task net with two segmentation heads (the JAX package's
``models/seg_model.py``, reference models/seg_model.py:12-117).

One train step is the JAX package's:

1. ``img_s2t = s2t(img_source)``: the translator in eval mode, under
   ``no_grad``; it never trains (its parameters take no gradient);
2. the task net's 'syn' head on ``img_s2t`` and its 'real' head on
   ``img_target``, in train mode, in that order (their BatchNorm
   statistics, under ``--norm batch``, move in that order);
3. a cross-entropy (ignore 255) of each head's output against its labels,
   their sum minimized by one Adam step (lr 1e-3, β (0.95, 0.999), eps
   1e-8) on the task net only; the LR is never stepped.

Both losses and both valid-pixel accuracies are reported. Only the task net
(``img2task``) is checkpointed, as in the JAX package: the translator is a
seeded random init unless ``load_reference_s2t`` loads a reference ``.pth``.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from . import register_model
from ..ops.layers import set_compute_dtype
from ..utils.weights import load_pth
from .base_model import BaseModel, ModelState
from .networks import define_G
from .seg_network import cross_entropy_loss, define_task_G, seg_accuracy


@register_model("seg")
class SegModel(BaseModel):
    loss_names = ("loss_lab_s", "loss_lab_t", "acc_real", "acc_syn")
    visual_names = ("img_s", "img_t", "lab_s_pre", "lab_s", "img_s2t",
                    "lab_t_pre", "lab_t")
    model_names = ("img2task",)
    lr_opt_names = ()  # a fixed LR, as in the reference

    def init_state(self, seed: int = None) -> ModelState:
        """Random init of the translator and the task net from ``seed``
        (default ``cfg.seed``) and the task net's Adam."""
        cfg = self.cfg
        gen = torch.Generator().manual_seed(cfg.seed if seed is None else seed)
        s2t = define_G(cfg.input_nc, cfg.output_nc, cfg.ngf, cfg.net_g,
                       norm=cfg.norm, use_dropout=not cfg.no_dropout,
                       init_type=cfg.init_type, init_gain=cfg.init_gain,
                       generator=gen)
        task = define_task_G(cfg.input_nc, cfg.ngf, 4, cfg.norm, "PReLU",
                             "UNet", cfg.init_type, weight=0.1, generator=gen)
        nets = {k: set_compute_dtype(v.to(self.device), cfg.compute_dtype())
                for k, v in (("s2t", s2t), ("img2task", task))}
        nets["s2t"].requires_grad_(False)
        opt = torch.optim.Adam(nets["img2task"].parameters(), lr=1e-3,
                               betas=(0.95, 0.999), eps=1e-8)
        return ModelState(nets=nets, optimizers={"T": opt}, pools={})

    def load_reference_s2t(self, state: ModelState, pth_path: str
                           ) -> ModelState:
        """Load a reference CycleGAN generator ``.pth`` into the frozen
        translator."""
        state.nets["s2t"].load_state_dict(load_pth(pth_path))
        return state

    # ------------------------------------------------------------------
    def _losses(self, nets, batch):
        f = lambda k: batch[k].to(self.device, torch.float32)  # noqa: E731
        img_s, img_t = f("img_source"), f("img_target")
        lab_s = batch["lab_source"].to(self.device, torch.long)
        lab_t = batch["lab_target"].to(self.device, torch.long)
        nets["s2t"].eval()
        with torch.no_grad():
            img_s2t = nets["s2t"](img_s)
        lab_s_pre = nets["img2task"](img_s2t, "syn")[1]
        lab_t_pre = nets["img2task"](img_t, "real")[1]
        loss_s = cross_entropy_loss(lab_s_pre, lab_s, 255)
        loss_t = cross_entropy_loss(lab_t_pre, lab_t, 255)
        aux = dict(img_s=img_s, img_t=img_t, lab_s=lab_s, lab_t=lab_t,
                   img_s2t=img_s2t, lab_s_pre=lab_s_pre, lab_t_pre=lab_t_pre)
        metrics = self.metrics_dict(
            loss_lab_s=loss_s, loss_lab_t=loss_t,
            acc_real=seg_accuracy(lab_t_pre, lab_t, 255),
            acc_syn=seg_accuracy(lab_s_pre, lab_s, 255))
        return loss_s + loss_t, aux, metrics

    def train_step(self, state: ModelState, batch
                   ) -> Tuple[ModelState, Dict[str, torch.Tensor]]:
        """One Adam step of the task net; ``batch`` holds NCHW
        ``img_source``/``img_target`` in [-1, 1] and NHW
        ``lab_source``/``lab_target``. Updates ``state`` in place."""
        state.nets["img2task"].train()
        loss, _, metrics = self._losses(state.nets, batch)
        opt = state.optimizers["T"]
        opt.zero_grad(set_to_none=True)
        loss.backward()
        self.optimizer_step(opt)
        state.step += 1
        return state, metrics

    def eval_step(self, state: ModelState, batch
                  ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
        """Losses and accuracies of the current task net in eval mode, and
        the visuals (images, label maps, predicted label maps)."""
        state.nets["img2task"].eval()
        with torch.no_grad():
            _, aux, metrics = self._losses(state.nets, batch)
        visuals = dict(img_s=aux["img_s"], img_t=aux["img_t"],
                       lab_s_pre=aux["lab_s_pre"].argmax(1),
                       lab_s=aux["lab_s"], img_s2t=aux["img_s2t"],
                       lab_t_pre=aux["lab_t_pre"].argmax(1),
                       lab_t=aux["lab_t"])
        return metrics, visuals
