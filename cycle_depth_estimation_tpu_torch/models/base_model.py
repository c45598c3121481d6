"""The model lifecycle shared by trainable models (the JAX package's
``models/base_model.py``, reference models/base_model.py:7-171).

The JAX package threads an immutable ``ModelState`` through pure jitted
steps. Here the state holds the nets (``nn.Module``s, whose parameters are
the params), their ``torch.optim`` optimizers, the image pools and the step
count, and a train step updates it in place: eager PyTorch has no use for
the copy, and the parameters and Adam moments of a model are its largest
buffers.

- ``make_optimizer``: Adam with betas (beta1, 0.999) and eps 1e-8 (S2D
  passes its ``adam_eps``), the update of the JAX package's ``optax.adam``
  (and of the reference); ``clip_grad_global_norm_``, optax's
  ``clip_by_global_norm`` rule before such a step.
- ``update_learning_rate``: the epoch LR policy (``lambda``, ``step``,
  ``cosine``, ``plateau``), the plateau state kept on the host and not
  checkpointed, as in the JAX package.
- ``save_networks`` / ``load_networks``: one ``{epoch}_net_{name}.pth`` per
  net with the reference's state-dict names (BatchNorm statistics
  included), so reference tools read them, plus ``{epoch}_train_state.pth``
  with the optimizer states, the pools and the step; ``load_nets`` reads
  the nets alone. Under ``parallel/`` layouts the tensors are gathered
  whole first (every rank takes part) and rank 0 writes.
- ``optimizer_step``: every optimizer step of a train step. Under data
  parallelism it first averages the gradient over the ``data`` group
  (``parallel.collectives.sync_grads``; a ``ZeroOptimizer`` reduce-scatters
  it), after summing it over ``model`` under ``--parallel sp``
  (``sync_replicas``), so a clip sees the global gradient; ``metrics_dict`` averages the
  step's losses over ``data``, so they are global means as the JAX
  metrics are.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Iterable, Tuple

import torch
from torch import nn

from ..config import Config
from ..device import resolve_device
from ..parallel import collectives
from ..parallel.tensor import gathered_optimizer_state, gathered_state_dict
from ..parallel.zero import ZeroOptimizer, gather_params
from ..utils.image_pool import ImagePool
from ..utils.weights import load_pth
from .networks import lr_schedule


@dataclass
class ModelState:
    nets: Dict[str, nn.Module]
    optimizers: Dict[str, torch.optim.Optimizer]
    pools: Dict[str, ImagePool]
    step: int = 0


def make_optimizer(params: Iterable[torch.Tensor], lr: float,
                   beta1: float, eps: float = 1e-8) -> torch.optim.Adam:
    """Adam as the reference builds it (betas=(beta1, 0.999), eps=1e-8;
    e.g. models/cycle_gan_model.py:66-69). Its first step moves each
    parameter by lr·g/(|g| + eps), about sign(g)·lr at eps 1e-8."""
    return torch.optim.Adam(params, lr=lr, betas=(beta1, 0.999), eps=eps)


def clip_grad_global_norm_(params: Iterable[torch.Tensor],
                           max_norm: float) -> torch.Tensor:
    """optax's ``clip_by_global_norm`` on the ``.grad`` of ``params``, in
    place: with ‖g‖ the L2 norm over every gradient, g is left as it is
    where ‖g‖ < ``max_norm`` and becomes g / ‖g‖ · ``max_norm`` otherwise
    (``torch.nn.utils.clip_grad_norm_`` divides by ‖g‖ + 1e-6 instead).
    No host sync. Returns ‖g‖."""
    grads = [p.grad for p in params]
    norm = torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(g.float()) for g in grads]))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))
    return norm


def optimizer_params(opt) -> list:
    """The parameters an optimizer (or a ``ZeroOptimizer``) steps."""
    if isinstance(opt, ZeroOptimizer):
        return opt.params
    return [p for g in opt.param_groups for p in g["params"]]


class BaseModel:
    loss_names: Tuple[str, ...] = ()
    visual_names: Tuple[str, ...] = ()
    model_names: Tuple[str, ...] = ()
    lr_opt_names: Tuple[str, ...] = ()
    # nets whose gradient a train step clips (``clip_grad_global_norm_``)
    # to this global norm before their optimizer step
    clip_norms: Dict[str, float] = {}

    def __init__(self, cfg: Config, device=None):
        self.cfg = cfg
        self.device = resolve_device(cfg.device if device is None else device)
        # host-side ReduceLROnPlateau state (torch defaults: mode 'min',
        # factor 0.2, threshold 0.01 relative, patience 5; reference
        # models/networks.py:32)
        self._plateau = None

    def update_learning_rate(self, state: ModelState, epoch: int,
                             metric: float = None) -> ModelState:
        """Set every scheduled optimizer's LR for ``epoch``. ``plateau``
        steps on ``metric`` (the train CLI passes the epoch's eval mean)
        and holds the LR when none is given."""
        cfg = self.cfg
        if cfg.lr_policy == "plateau":
            if self._plateau is None:
                self._plateau = {"best": float("inf"), "bad": 0, "scale": 1.0}
            ps = self._plateau
            if metric is not None:
                if metric < ps["best"] * (1.0 - 0.01):
                    ps["best"], ps["bad"] = float(metric), 0
                else:
                    ps["bad"] += 1
                    if ps["bad"] > 5:
                        ps["scale"] *= 0.2
                        ps["bad"] = 0
            lr = cfg.lr * ps["scale"]
        else:
            lr = lr_schedule(cfg.lr_policy, cfg.lr, epoch=epoch,
                             niter=cfg.niter, niter_decay=cfg.niter_decay,
                             lr_decay_iters=cfg.lr_decay_iters)
        for name in self.lr_opt_names:
            for group in state.optimizers[name].param_groups:
                group["lr"] = lr
        return state

    @staticmethod
    def optimizer_step(opt, max_norm: float = None) -> None:
        """Step ``opt`` on its parameters' ``.grad``: averaged over the
        ``data`` group first (and, for the parameters tensor parallelism
        leaves whole, averaged over ``model``; under spatial parallelism
        every one summed over ``model``), then clipped to the global norm
        ``max_norm`` (``clip_grad_global_norm_``) where one is given."""
        params = optimizer_params(opt)
        collectives.sync_replicas(params)
        if isinstance(opt, ZeroOptimizer):
            opt.reduce_grads()
            if max_norm is not None:
                opt.clip_grad_global_norm_(max_norm)
        else:
            collectives.sync_grads(params)
            if max_norm is not None:
                clip_grad_global_norm_(params, max_norm)
        opt.step()

    def step_generator(self, state: ModelState) -> torch.Generator:
        """A CPU generator seeded by ``seed`` and the step: what a step
        draws from it, the card and the CPU draw alike, and a resumed run
        draws what the run would have."""
        return torch.Generator().manual_seed(
            (self.cfg.seed + 1) * 1_000_003 + state.step)

    # ---- checkpoints ----------------------------------------------------
    def _paths(self, epoch) -> Dict[str, str]:
        d = self.cfg.expr_dir()
        paths = {name: os.path.join(d, f"{epoch}_net_{name}.pth")
                 for name in self.model_names}
        paths["train_state"] = os.path.join(d, f"{epoch}_train_state.pth")
        return paths

    def save_networks(self, state: ModelState, epoch) -> Dict[str, str]:
        paths = self._paths(epoch)
        gather_params(state)
        nets = {name: {k: v.detach().cpu() for k, v in
                       gathered_state_dict(state.nets[name]).items()}
                for name in self.model_names}
        optimizers = {k: (o.state_dict() if isinstance(o, ZeroOptimizer)
                          else gathered_optimizer_state(o))
                      for k, o in state.optimizers.items()}
        pools = {k: p.state_dict() for k, p in state.pools.items()}
        if not collectives.is_writer():
            return paths
        os.makedirs(self.cfg.expr_dir(), exist_ok=True)
        for name in self.model_names:
            torch.save(nets[name], paths[name])
        torch.save({"optimizers": optimizers, "pools": pools,
                    "step": state.step}, paths["train_state"])
        return paths

    def has_checkpoint(self, epoch) -> bool:
        paths = self._paths(epoch)
        return all(os.path.isfile(paths[n]) for n in self.model_names)

    def load_nets(self, state: ModelState, epoch) -> ModelState:
        """Load the nets' ``.pth`` files only (parameters and BatchNorm
        statistics), as serving does."""
        paths = self._paths(epoch)
        for name in self.model_names:
            state.nets[name].load_state_dict(load_pth(paths[name]))
        return state

    def load_networks(self, state: ModelState, epoch) -> ModelState:
        paths = self._paths(epoch)
        self.load_nets(state, epoch)
        rest = torch.load(paths["train_state"], map_location=self.device,
                          weights_only=True)
        for k, sd in rest["optimizers"].items():
            state.optimizers[k].load_state_dict(sd)
        for k, sd in rest["pools"].items():
            state.pools[k].load_state_dict(
                {**sd, "rng": sd["rng"].cpu()})
        state.step = int(rest["step"])
        return state

    def metrics_dict(self, **kw) -> Dict[str, torch.Tensor]:
        """Losses as detached fp32 0-d tensors on the device, averaged over
        the ``data`` group: reading one (``float(v)``) is the caller's
        choice of when to sync."""
        return collectives.mean_over_data(
            {k: torch.as_tensor(v).detach().float() for k, v in kw.items()})
