"""A single-controller slab mesh: one process drives D slabs, one per mesh
device, and moves data between them with explicit tensor copies (port of
the reference package's 1D ``jax.sharding.Mesh`` over the axis ``"x"``,
``parallel/shard.make_mesh``, and of the collectives its slab code runs
under ``shard_map``).

Slab d lives on ``mesh.devices[d]``.  Devices may repeat: D slabs on one
card (``SlabMesh(["cuda:0"] * 4)``) run the same code as D slabs on D cards,
and a CPU mesh (``SlabMesh(["cpu"] * 4)``) runs it with the kernels'
PyTorch twins.  On distinct cards a shift is a peer copy.

The collectives are exactly those of the reference's slab code:

* ``shift_fwd`` / ``shift_bwd``: the nearest-neighbour ``ppermute`` pairs
  (``_fwd_perm``: slab d receives slab d-1's value; ``_bwd_perm``: slab
  d+1's); the edge slab with no such neighbour receives the fill;
* ``max`` / ``min`` over slabs: ``pmax`` / ``pmin`` (the frame's colour
  bounds), the result on every slab's device;
* ``any``: the collective rebin trigger, read back to the host in ONE sync
  for all D slabs.
"""

from __future__ import annotations

import torch


class SlabMesh:
    """An ordered list of ``torch.device``, one per slab (repeats allowed).
    ``SlabMesh(n=D)`` puts D slabs on the current CUDA card."""

    def __init__(self, devices=None, n: int | None = None):
        if devices is None:
            if n is None:
                raise ValueError("SlabMesh: give the devices or n")
            devices = ["cuda"] * n
        self.devices = [torch.device(d) for d in devices]
        self.devices = [torch.device("cuda", torch.cuda.current_device())
                        if d.type == "cuda" and d.index is None else d
                        for d in self.devices]
        if not self.devices:
            raise ValueError("SlabMesh: no devices")

    @property
    def n(self) -> int:
        """The number of slabs, D."""
        return len(self.devices)

    def _fill(self, like: torch.Tensor, fill, d: int) -> torch.Tensor:
        """What an edge slab receives: ``fill`` in ``like``'s shape (a
        tensor fill as a broadcast view, read only)."""
        if isinstance(fill, torch.Tensor):
            return fill.to(self.devices[d], like.dtype).expand(like.shape)
        return torch.full(like.shape, fill, dtype=like.dtype,
                          device=self.devices[d])

    def shift_fwd(self, xs: list, fill=0) -> list:
        """``ppermute`` over (d, d+1): out[d] = xs[d-1] on slab d's device;
        slab 0 receives ``fill`` (a scalar, or a tensor broadcast to the
        shape; the results are read, not written)."""
        return [self._fill(xs[0], fill, 0)] + [
            xs[d - 1].to(self.devices[d]) for d in range(1, self.n)]

    def shift_bwd(self, xs: list, fill=0) -> list:
        """``ppermute`` over (d+1, d): out[d] = xs[d+1] on slab d's device;
        the last slab receives ``fill``."""
        return [xs[d + 1].to(self.devices[d])
                for d in range(self.n - 1)] + [
            self._fill(xs[-1], fill, self.n - 1)]

    def max(self, xs: list) -> list:
        """``pmax``: the elementwise max over the slabs' tensors, on every
        slab's device."""
        return self._reduce(xs, torch.maximum)

    def min(self, xs: list) -> list:
        """``pmin``: the elementwise min over the slabs' tensors."""
        return self._reduce(xs, torch.minimum)

    def _reduce(self, xs: list, op) -> list:
        acc = xs[0]
        for d in range(1, self.n):
            acc = op(acc, xs[d].to(acc.device))
        return [acc.to(dev) for dev in self.devices]

    def any(self, xs: list) -> bool:
        """Whether any element of any slab's bool tensor is set: ONE host
        sync for all slabs (the trigger's read-back)."""
        dev = self.devices[0]
        return bool(torch.stack([x.to(dev).reshape(-1).any() if x.dim()
                                 else x.to(dev) for x in xs]).any())
