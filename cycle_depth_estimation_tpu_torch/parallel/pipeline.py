"""Pipeline parallelism: a GPipe schedule for a trunk of like blocks (the
JAX package's ``parallel/pipeline.py``), a library call as in the JAX
package (the train CLI has no pipeline mode).

``stack_stage_params`` stacks L blocks' parameters into tensors of
leading shape (S, L/S): stage s holds blocks s·k … s·k+k−1.
``gpipe_apply`` runs the trunk over the ``stage`` group of a mesh, one
rank a stage: the batch is cut into M microbatches, stage 0 feeds them
in, each stage applies its k blocks to a microbatch and sends the
activation to the next, and the last stage's outputs reach every rank,
as the JAX function's closing ``psum`` delivers them.

It is differentiable, one autograd function a rank: its forward keeps
each microbatch's graph (GPipe's stored activations), its backward walks
the microbatches in reverse order, receives each output's gradient from
the next stage (the last stage takes the caller's), runs the microbatch's
backward and sends the input's gradient to the stage before. Every rank
is meant to compute the same loss from the result (it is replicated), so
the delivery to every rank passes the last stage's gradient through (the
other ranks' copies are not summed into it), and the input's gradient
reaches every rank. A stage's parameters get the gradient of its own
blocks only: sum over ``stage`` (and over ``data``) for whole gradients
on every rank.

With ``data_axis`` each ``data`` index runs a pipeline of its own on its
rows of every microbatch (a ``('data', 'stage')`` mesh); the result is
gathered over ``data``.

The sends and receives are point to point between neighbouring stages,
posted in one order by both sides (stage s−1 sends microbatch m before
m+1, stage s receives it so), which cannot deadlock: the dependencies run
one way along the chain. On gloo a CUDA tensor crosses pinned host memory
(gloo's rule, as ``collectives`` applies it to its collectives).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Mapping, Sequence

import torch
import torch.distributed as dist

from .collectives import (Groups, all_gather_cat, all_reduce_, copy_to_model,
                          reduce_from_model)

_DTYPES = (torch.float32, torch.bfloat16, torch.float16, torch.float64)


def stack_stage_params(blocks: Sequence, n_stages: int
                       ) -> Dict[str, torch.Tensor]:
    """[p_0 … p_{L−1}], each a block's parameters (an ``nn.Module`` or a
    name → tensor mapping), → name → tensor of shape (S, L/S, …): stage s
    holds blocks s·k … s·k+k−1. Differentiable (``torch.stack``)."""
    blocks = [dict(b.named_parameters()) if isinstance(b, torch.nn.Module)
              else dict(b) for b in blocks]
    L = len(blocks)
    assert L % n_stages == 0, (L, n_stages)
    k = L // n_stages
    return {name: torch.stack([b[name] for b in blocks]).reshape(
        (n_stages, k) + tuple(t.shape)) for name, t in blocks[0].items()}


# ---- point to point ------------------------------------------------------
def _send(t: torch.Tensor, peer: int, group, keep: List) -> None:
    h = t.detach().contiguous()
    if h.is_cuda and dist.get_backend(group) == "gloo":
        h = h.to("cpu", copy=True).pin_memory()
    keep.append((dist.isend(h, dist.get_global_rank(group, peer),
                            group=group), h))


def _recv(shape, dtype, device, peer: int, group) -> torch.Tensor:
    staged = device.type == "cuda" and dist.get_backend(group) == "gloo"
    buf = torch.empty(shape, dtype=dtype,
                      device="cpu" if staged else device, pin_memory=staged)
    dist.irecv(buf, dist.get_global_rank(group, peer), group=group).wait()
    return buf.to(device)


class _GPipe(torch.autograd.Function):
    @staticmethod
    def forward(ctx, run, xs, *params):
        block_apply, names, k, group, s, S, need_grad = run
        M, n = xs.shape[0], len(names)
        leaves = [p.detach().requires_grad_(p.requires_grad)
                  for p in params]
        blocks = [dict(zip(names, leaves[j * n:(j + 1) * n]))
                  for j in range(k)]

        def stage_fn(h_in):
            with torch.set_grad_enabled(need_grad):
                h = h_in.requires_grad_(need_grad)
                for p in blocks:
                    h = block_apply(p, h)
            return h_in, h

        dtype, first = xs.dtype, None
        if s == 0:
            first = stage_fn(xs[0].detach())
            if first[1].dtype != dtype:
                # the blocks compute in another dtype: every microbatch
                # enters in the blocks' output dtype (the JAX carry's rule)
                dtype = first[1].dtype
                first = stage_fn(xs[0].detach().to(dtype))
        if S > 1:  # the stages agree on the activations' dtype first
            code = torch.tensor([_DTYPES.index(dtype) if s == 0 else 0],
                                device=xs.device)
            dtype = _DTYPES[int(all_reduce_(code, group))]
        ins, outs, keep = [], [], []
        for m in range(M):
            if m == 0 and first is not None:
                h_in, h = first
            elif s == 0:
                h_in, h = stage_fn(xs[m].detach().to(dtype))
            else:
                h_in, h = stage_fn(_recv(xs.shape[1:], dtype, xs.device,
                                         s - 1, group))
            ins.append(h_in)
            outs.append(h)
            if s < S - 1:
                _send(h, s + 1, group, keep)
        for work, _ in keep:
            work.wait()
        ctx.run, ctx.ins, ctx.outs, ctx.leaves = run, ins, outs, leaves
        ctx.x_dtype = xs.dtype
        if s == S - 1:
            return torch.stack([h.detach() for h in outs])
        return xs.new_zeros(xs.shape, dtype=dtype)

    @staticmethod
    def backward(ctx, gy):
        _, _, _, group, s, S, _ = ctx.run
        ins, outs, leaves = ctx.ins, ctx.outs, ctx.leaves
        M = len(outs)
        wanted = [p for p in leaves if p.requires_grad]
        grads = [torch.zeros_like(p) for p in leaves]
        gx = gy.new_zeros((M,) + tuple(ins[0].shape), dtype=ctx.x_dtype)
        keep = []
        for m in reversed(range(M)):
            out = outs[m]
            g = (gy[m].to(out.dtype) if s == S - 1 else
                 _recv(out.shape, out.dtype, out.device, s + 1, group))
            got = torch.autograd.grad(out, [ins[m]] + wanted, g,
                                      allow_unused=True)
            if s > 0:
                _send(got[0], s - 1, group, keep)
            else:
                gx[m] = got[0].to(ctx.x_dtype)
            it = iter(got[1:])
            for i, p in enumerate(leaves):
                if p.requires_grad:
                    d = next(it)
                    if d is not None:
                        grads[i] += d
        for work, _ in keep:
            work.wait()
        ctx.ins = ctx.outs = None
        return (None, gx, *grads)


class _TakeRows(torch.autograd.Function):
    """Rows ``[a, b)`` of dim 1; backward: the ranks' row gradients
    gathered over ``group`` (each rank's loss reads every row)."""

    @staticmethod
    def forward(ctx, x, a, b, group):
        ctx.group = group
        return x[:, a:b].clone()

    @staticmethod
    def backward(ctx, g):
        return all_gather_cat(g.contiguous(), ctx.group, 1), None, None, None


class _GatherRows(torch.autograd.Function):
    """The ranks' rows concatenated along dim 1; backward: this rank's
    rows of the gradient (every rank computes the same loss from it)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.n, ctx.r = x.shape[1], dist.get_rank(group)
        return all_gather_cat(x.detach(), group, 1)

    @staticmethod
    def backward(ctx, g):
        return g[:, ctx.r * ctx.n:(ctx.r + 1) * ctx.n], None


def gpipe_apply(block_apply: Callable[[Mapping[str, torch.Tensor],
                                       torch.Tensor], torch.Tensor],
                stage_params: Mapping[str, torch.Tensor], x: torch.Tensor,
                groups: Groups, n_microbatches: int,
                data_axis: str = None) -> torch.Tensor:
    """Run the stacked-block trunk as an S-stage GPipe over
    ``groups.stage`` (S = ``groups.stage_size``; this rank is stage
    ``groups.stage_rank``).

    ``block_apply(params, h) -> h`` applies ONE block (e.g.
    ``torch.func.functional_call(block, params, (h,))``); ``stage_params``
    comes from ``stack_stage_params``. ``x`` is the global batch on every
    rank, cut into ``n_microbatches`` equal microbatches; the result is
    the global output on every rank, in the blocks' output dtype.
    ``data_axis='data'`` gives each ``groups.data`` index its own pipeline
    on its rows of each microbatch."""
    S, s = groups.stage_size, groups.stage_rank
    M, B = n_microbatches, x.shape[0]
    assert B % M == 0, (B, M)
    assert S == 1 or groups.stage is not None, "no 'stage' group"
    names = list(stage_params)
    k = next(iter(stage_params.values())).shape[1]
    # this stage's blocks, block-major: params[j·len(names) + i] is block
    # j's parameter names[i]
    params = [stage_params[n][s, j] for j in range(k) for n in names]
    group = groups.stage
    if group is not None:
        x = copy_to_model(x, group)
    xs = x.reshape((M, B // M) + tuple(x.shape[1:]))
    dgroup = None
    if data_axis:
        assert data_axis == "data", data_axis
        D, d = groups.data_size, groups.data_rank
        assert (B // M) % D == 0, (B, M, D)
        dgroup = groups.data
        if dgroup is not None:
            n = B // M // D
            xs = _TakeRows.apply(xs, d * n, (d + 1) * n, dgroup)
    need_grad = torch.is_grad_enabled() and (
        x.requires_grad or any(p.requires_grad for p in params))
    run = (block_apply, names, k, group, s, S, need_grad)
    y = _GPipe.apply(run, xs, *params)
    if group is not None:
        y = reduce_from_model(y, group)
    if dgroup is not None:
        y = _GatherRows.apply(y, dgroup)
    return y.reshape((B,) + tuple(y.shape[2:]))
