"""ImagePool: the discriminator's replay buffer of generated images (the JAX
package's ``utils/image_pool.py``, reference util/image_pool.py:5-32).

Per image of a query, in batch order:

- while the pool is under-full: store the image, return the image;
- once full: with p > 0.5 return a random stored image and store the new
  one in its place; otherwise return the image.

``pool_size`` 0 is the identity. The buffer is fp32 and so is what a
query returns, whatever the images' dtype (the JAX pool's; a bf16 image
converts exactly). The buffer is one (pool_size, C, H, W) tensor that the
first query allocates on its images' device and later queries write in
place, so one pool serves any image size; the draws come from the
pool's own CPU ``torch.Generator``, so the choices need no device sync and
are the same on every device for one seed. The JAX pool draws from
``jax.random`` keys instead, so the two agree draw for draw only while the
pool is under-full, where nothing is drawn.

Under data parallelism a query sees the global batch, as the JAX pool does:
each rank all-gathers the fakes over ``data``, runs the same query with the
same generator state, and keeps its own rows, so the pool stays the same on
every rank.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..parallel import collectives


class ImagePool:
    def __init__(self, pool_size: int, device=None,
                 generator: Optional[torch.Generator] = None):
        """``device`` is where ``load_state_dict`` puts the buffer."""
        self.pool_size = pool_size
        self.device = device
        self.images: Optional[torch.Tensor] = None
        self.count = 0
        self.generator = (torch.Generator().manual_seed(0)
                          if generator is None else generator)

    def query(self, batch: torch.Tensor) -> torch.Tensor:
        """Return the batch the discriminator sees (``batch`` is not
        modified; the pool keeps copies)."""
        if self.pool_size == 0:
            return batch
        batch = collectives.gather_rows(batch.detach())
        if self.images is None:
            self.images = torch.zeros((self.pool_size, *batch.shape[1:]),
                                      device=batch.device)
        out = batch.to(self.images.dtype, copy=True)
        for i in range(batch.shape[0]):
            if self.count < self.pool_size:
                self.images[self.count].copy_(batch[i])
                self.count += 1
                continue
            p = float(torch.rand((), generator=self.generator))
            rid = int(torch.randint(0, self.pool_size, (),
                                    generator=self.generator))
            if p > 0.5:
                out[i].copy_(self.images[rid])
                self.images[rid].copy_(batch[i])
        return collectives.local_rows(out)

    def state_dict(self) -> Dict[str, object]:
        return {"images": self.images, "count": self.count,
                "rng": self.generator.get_state()}

    def load_state_dict(self, sd: Dict[str, object]) -> None:
        self.images = (None if sd["images"] is None
                       else sd["images"].to(self.device, copy=True))
        self.count = int(sd["count"])
        self.generator.set_state(sd["rng"])
