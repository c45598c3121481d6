"""ZeRO: optimizer state, and optionally the parameters, split over the
``data`` axis (the JAX package's ``parallel/zero.py``).

The rule is the JAX one (``zero_dim``): split a tensor's largest dimension
that divides by the ``data`` size; scalars and shapes with no such
dimension stay whole on every rank.

- ``--zero opt`` (ZeRO-1): each rank keeps its slice of every Adam moment.
  The gradient is reduce-scattered, each rank steps ``torch.optim.Adam`` on
  its slice of each parameter (a view of it: the update is elementwise the
  one ``make_optimizer`` makes), and the parameter is all-gathered.
- ``--zero fsdp``: the parameters are stored as the slices too. A forward
  pre-hook on each module of a net gathers the net's parameters at first
  use; the optimizer step reduce-scatters their gradients, updates the
  slices and frees the whole tensors again.

Checkpoints gather to whole tensors under the reference's names
(``ZeroOptimizer.state_dict`` is a ``torch.optim.Adam`` state dict of the
whole parameters), so a checkpoint saved under ``--zero`` loads into a run
without it, and the reverse.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Iterable, List, Optional

import torch

from . import collectives
from .collectives import all_gather_cat, all_reduce_, reduce_scatter


def zero_dim(shape, n: int) -> Optional[int]:
    """The dimension of ``shape`` that ZeRO splits over ``n`` ranks: the
    largest that divides by ``n`` (the first of equal ones), or None."""
    for i in sorted(range(len(shape)), key=lambda j: -shape[j]):
        if shape[i] >= n and shape[i] % n == 0:
            return i
    return None


def leaf_zero_sharding(leaf: Any, n: int, axis: str = "data") -> tuple:
    """``zero_dim`` as a partition spec: ``axis`` at the split dimension,
    None elsewhere; () for a tensor kept whole (the JAX canonical form)."""
    shape = tuple(getattr(leaf, "shape", ()))
    d = zero_dim(shape, n)
    if d is None:
        return ()
    return tuple(axis if i == d else None for i in range(len(shape)))


def shard_tree_zero(tree: Dict[str, torch.Tensor], n: int, rank: int
                    ) -> Dict[str, torch.Tensor]:
    """Rank ``rank``'s slice of every tensor of ``tree`` by the rule."""
    return {k: _slice(v, zero_dim(v.shape, n), n, rank)
            for k, v in tree.items()}


def _slice(t: torch.Tensor, d: Optional[int], n: int, rank: int):
    if d is None:
        return t
    k = t.shape[d] // n
    return t.narrow(d, rank * k, k)


class ZeroOptimizer:
    """An Adam (``make_optimizer``'s) whose moments live as this rank's
    slices; with ``shard_params`` the parameters too."""

    def __init__(self, optimizer: torch.optim.Optimizer, group, size: int,
                 rank: int, shard_params: bool = False):
        self.group, self.size, self.rank = group, size, rank
        self.shard_params = shard_params
        self.params: List[torch.nn.Parameter] = [
            p for g in optimizer.param_groups for p in g["params"]]
        self.dims = [zero_dim(p.shape, size) for p in self.params]
        it = iter(zip(self.params, self.dims))
        groups = []
        for g in optimizer.param_groups:
            shards = []
            for p, d in (next(it) for _ in g["params"]):
                s = _slice(p.detach(), d, size, rank)
                # fsdp: the slices are the storage; opt: views of the params
                shards.append(s.clone() if shard_params else s)
            groups.append({**{k: v for k, v in g.items() if k != "params"},
                           "params": shards})
        self.shards = [s for g in groups for s in g["params"]]
        self.inner = type(optimizer)(groups)
        sd = optimizer.state_dict()
        if sd["state"]:
            self.load_state_dict(sd)
        self.gathered = True
        if shard_params:
            self.release()

    @property
    def param_groups(self):
        return self.inner.param_groups

    def zero_grad(self, set_to_none: bool = True) -> None:
        for p in self.params:
            p.grad = None

    # ---- fsdp: the whole parameters exist only while in use -----------
    def gather(self) -> None:
        """Make every parameter whole (fsdp; a no-op once gathered)."""
        if self.gathered:
            return
        with torch.no_grad():
            for p, s, d in zip(self.params, self.shards, self.dims):
                p.data = (s.clone() if d is None
                          else all_gather_cat(s, self.group, d))
        self.gathered = True

    def release(self) -> None:
        """Free the whole parameters (fsdp), keeping the slices."""
        for p in self.params:
            p.data = torch.empty(0, dtype=p.dtype, device=p.device)
        self.gathered = False

    # ---- the step -------------------------------------------------------
    def reduce_grads(self) -> None:
        """Average each gradient over ``data`` into this rank's slice
        (reduce-scatter; a tensor kept whole is all-reduced); a ``None``
        gradient is zeros."""
        for p, s, d in zip(self.params, self.shards, self.dims):
            g = torch.zeros_like(p) if p.grad is None else p.grad
            if self.group is None:
                s.grad = _slice(g, d, 1, 0).clone()
            elif d is None:
                s.grad = all_reduce_(g.detach().clone(), self.group)
                s.grad /= self.size
            else:
                s.grad = (reduce_scatter(g, self.group, d)
                          / self.size).contiguous()
            p.grad = None

    def clip_grad_global_norm_(self, max_norm: float) -> torch.Tensor:
        """``base_model.clip_grad_global_norm_`` over the slices: the norm
        of the whole gradient (a tensor kept whole counted once)."""
        sq = sum(s.grad.float().pow(2).sum()
                 for s, d in zip(self.shards, self.dims)
                 if d is not None or self.rank == 0)
        sq = torch.as_tensor(sq, device=self.shards[0].device).reshape(1)
        if self.group is not None:
            all_reduce_(sq, self.group)
        norm = sq[0].sqrt()
        keep = norm < max_norm
        for s in self.shards:
            s.grad.copy_(torch.where(keep, s.grad, s.grad / norm * max_norm))
        return norm

    @torch.no_grad()
    def step(self) -> None:
        """Adam on the slices, then the whole parameters: all-gathered
        (opt) or freed (fsdp)."""
        self.inner.step()
        for s in self.shards:
            s.grad = None
        if self.shard_params:
            self.release()
            return
        for p, s, d in zip(self.params, self.shards, self.dims):
            if d is not None:
                p.copy_(all_gather_cat(s, self.group, d))

    # ---- checkpoints: whole tensors --------------------------------------
    def state_dict(self) -> Dict[str, Any]:
        sd = self.inner.state_dict()
        state = {}
        for i, st in sd["state"].items():
            d = self.dims[i]
            state[i] = {k: (all_gather_cat(v, self.group, d)
                            if d is not None and torch.is_tensor(v)
                            and v.dim() > 0 else v)
                        for k, v in st.items()}
        return {"state": state, "param_groups": sd["param_groups"]}

    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        state = {}
        for i, st in sd["state"].items():
            d = self.dims[int(i)]
            state[i] = {k: (_slice(v, d, self.size, self.rank).clone()
                            if torch.is_tensor(v) and v.dim() > 0 else v)
                        for k, v in st.items()}
        self.inner.load_state_dict({"state": state,
                                    "param_groups": sd["param_groups"]})


def zero_state(state, groups: collectives.Groups, shard_params: bool = False,
               skip: Iterable[str] = ()):
    """Lay ``state`` out for ZeRO over ``groups.data``: every optimizer but
    those named in ``skip`` becomes a ``ZeroOptimizer``; with
    ``shard_params`` each net whose parameters one of them holds gathers
    them at its first use. Batch statistics, pools and the step stay
    whole on every rank."""
    owner = {}
    for name, opt in list(state.optimizers.items()):
        if name in skip:
            continue
        z = ZeroOptimizer(opt, groups.data, groups.data_size,
                          groups.data_rank, shard_params)
        state.optimizers[name] = z
        owner.update({id(p): z for p in z.params})
    if shard_params:
        for net in state.nets.values():
            opts = {id(owner[id(p)]): owner[id(p)]
                    for p in net.parameters() if id(p) in owner}
            if not opts:
                continue
            hook = _gather_hook(list(opts.values()))
            for m in net.modules():
                m.register_forward_pre_hook(hook)
    return state


def _gather_hook(opts):
    def hook(module, inputs):
        for z in opts:
            z.gather()
    return hook


def gather_params(state) -> None:
    """Make every parameter of ``state`` whole (fsdp; before a checkpoint
    or an export). A collective: every rank calls it."""
    for opt in state.optimizers.values():
        if isinstance(opt, ZeroOptimizer):
            opt.gather()


# ---- memory -----------------------------------------------------------------
def _nbytes(x) -> int:
    size = math.prod(x.shape)
    item = x.element_size() if torch.is_tensor(x) else x.dtype.itemsize
    return size * item


def _tree_bytes(tree) -> int:
    return sum(_nbytes(x) for x in tree)


def _tree_bytes_per_device(tree, n: int, sharded: bool) -> int:
    if not sharded:
        return _tree_bytes(tree)
    return sum(_nbytes(x) // (n if zero_dim(x.shape, n) is not None else 1)
               for x in tree)


def state_trees(state) -> Dict[str, List[torch.Tensor]]:
    """The persistent state of a model as shapes (meta tensors): its
    parameters, the Adam state its optimizers hold for them (two moments
    of each parameter's shape and a 0-d step), and its nets' buffers."""
    def meta(t):
        return torch.empty(t.shape, dtype=t.dtype, device="meta")

    params = [meta(p) for net in state.nets.values()
              for p in net.parameters()]
    opt = []
    for o in state.optimizers.values():
        for g in o.param_groups:
            for p in g["params"]:
                opt += [meta(p), meta(p),
                        torch.empty((), dtype=torch.float32, device="meta")]
    stats = [meta(b) for net in state.nets.values() for b in net.buffers()]
    return {"params": params, "opt_states": opt, "batch_stats": stats}


def memory_report(trees: Dict[str, Iterable], n: int,
                  shard_params: bool = False, axis: str = "data") -> dict:
    """Per-rank bytes of the persistent state, replicated against the ZeRO
    layout over ``n`` ranks (the JAX dict; ``trees`` as ``state_trees``
    gives them, of the state before it is laid out)."""
    rep = {k: _tree_bytes(trees[k])
           for k in ("params", "opt_states", "batch_stats")}
    zero = {
        "params": _tree_bytes_per_device(trees["params"], n, shard_params),
        "opt_states": _tree_bytes_per_device(trees["opt_states"], n, True),
        "batch_stats": rep["batch_stats"],
    }
    return {
        "mesh_axis": f"{axis}={n}",
        "replicated_per_device_bytes": rep,
        "zero_per_device_bytes": zero,
        "replicated_total_mib": round(sum(rep.values()) / 2**20, 1),
        "zero_total_mib": round(sum(zero.values()) / 2**20, 1),
    }


def resident_bytes(state) -> Dict[str, int]:
    """The bytes this rank holds for ``state``, measured on its tensors
    (each storage once): parameters (with fsdp's slices), optimizer state
    and the nets' buffers."""
    seen = set()

    def count(tensors):
        total = 0
        for t in tensors:
            st = t.untyped_storage()
            if st.data_ptr() in seen or st.nbytes() == 0:
                continue
            seen.add(st.data_ptr())
            total += st.nbytes()
        return total

    params = [p for net in state.nets.values() for p in net.parameters()]
    opt = []
    for o in state.optimizers.values():
        if isinstance(o, ZeroOptimizer):
            params += o.shards
            o = o.inner
        opt += [v for st in o.state.values() for v in st.values()
                if torch.is_tensor(v)]
    return {"params": count(params), "opt_states": count(opt),
            "batch_stats": count([b for net in state.nets.values()
                                  for b in net.buffers()])}
