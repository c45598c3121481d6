"""Rank work of the port's parallel tests (``test_torch_port_parallel.py``,
``test_torch_port_multihost.py``), in a module of its own: spawned ranks
import it by name, and it imports neither JAX nor pytest."""

from __future__ import annotations

import torch

from cycle_depth_estimation_tpu_torch.ops.layers import BatchNorm
from cycle_depth_estimation_tpu_torch.parallel import collectives, dryrun
from cycle_depth_estimation_tpu_torch.models.seg_network import (
    cross_entropy_loss, seg_accuracy)
from cycle_depth_estimation_tpu_torch.utils.image_pool import ImagePool


def _activate():
    return collectives.activate(dryrun.layout_groups({}))


def batch_norm_case(x, weight, bias, r):
    """A train-mode ``BatchNorm`` on this rank's rows of ``x``, loss
    Σ y·r: the output, input gradient and running statistics (gathered
    or as every rank holds them) and the synced weight/bias gradients."""
    prev = _activate()
    try:
        bn = BatchNorm(x.shape[1])
        with torch.no_grad():
            bn.weight.copy_(weight)
            bn.bias.copy_(bias)
        xs = collectives.local_rows(x).clone().requires_grad_(True)
        y = bn(xs)
        (y * collectives.local_rows(r)).sum().backward()
        collectives.sync_grads(bn.parameters())
        return {"y": collectives.gather_rows(y.detach()),
                "dx": collectives.gather_rows(xs.grad),
                "dw": bn.weight.grad, "db": bn.bias.grad,
                "running_mean": bn.running_mean.clone(),
                "running_var": bn.running_var.clone(),
                "count": int(bn.num_batches_tracked)}
    finally:
        collectives.activate(prev)


def cross_entropy_case(logits, labels):
    """``cross_entropy_loss`` and ``seg_accuracy`` on this rank's rows; the
    logits' gradient, gathered."""
    prev = _activate()
    try:
        lg = collectives.local_rows(logits).clone().requires_grad_(True)
        lab = collectives.local_rows(labels)
        loss = cross_entropy_loss(lg, lab, 255)
        loss.backward()
        return {"loss": float(loss.detach()),
                "acc": float(seg_accuracy(lg, lab, 255)),
                "dlogits": collectives.gather_rows(lg.grad)}
    finally:
        collectives.activate(prev)


def pool_case(batches, pool_size, seed):
    """Each query's returned batch (gathered) and the pool after them."""
    prev = _activate()
    try:
        pool = ImagePool(pool_size,
                         generator=torch.Generator().manual_seed(seed))
        outs = [collectives.gather_rows(pool.query(collectives.local_rows(b)))
                for b in batches]
        return {"outs": outs, "images": pool.images.clone(),
                "count": pool.count}
    finally:
        collectives.activate(prev)


def all_gather_case(x, w):
    """``collectives.all_gather`` of this rank's rows of ``x``, loss
    Σ y·w: the gathered batch and the rows' gradient, gathered."""
    prev = _activate()
    try:
        xs = collectives.local_rows(x).clone().requires_grad_(True)
        y = collectives.all_gather(xs, collectives.active().data)
        (y * w).sum().backward()
        return {"y": y.detach(), "dx": collectives.gather_rows(xs.grad)}
    finally:
        collectives.activate(prev)


def all_cases(cyc, cyc_batch, init_sd, tp, tp_x, bn, ce, pool, gather):
    """Every case of ``test_torch_port_parallel`` in one world."""
    out = {"dp": dryrun.model_step(cyc, cyc_batch, {}, init_sd),
           "dp_eps": dryrun.model_step(cyc, cyc_batch, {}, init_sd, 1e-2)}
    for zero in ("opt", "fsdp"):
        out[f"zero_{zero}"] = dryrun.model_step(
            cyc, cyc_batch, {"zero": zero}, init_sd, 1e-2)
    out["tp"] = dryrun.tp_case(tp, tp_x, {"mesh_shape": [1, 2]})
    out["tp_step"] = dryrun.model_step(
        cyc, cyc_batch, {"mesh_shape": [1, 2], "parallel": "tp"}, init_sd,
        1e-2)
    out["bn"] = batch_norm_case(*bn)
    out["ce"] = cross_entropy_case(*ce)
    out["pool"] = pool_case(*pool)
    out["gather"] = all_gather_case(*gather)
    return out
