"""Device meshes for one process: a 1-D or 2-D grid of torch.devices.

The port of ``fast_srgan_tpu/parallel/mesh.py``'s single-process half. A
:class:`Mesh` names its axes, as JAX's does (``("sp",)``, ``("data",)``,
``("data", "sp")``); the code that runs over it moves tensors between its
devices itself (``Tensor.to``, ordered on the consumer's current stream),
since nothing compiles a program across devices here. A device may appear
more than once: the shards of one card then run one after another on it,
with the same halo and statistics exchange as across cards (the tests
shard over a repeated ``cpu``, and ``chip_smoke.py`` over ``cuda:0``).
The multi-host half of ``shard_batch`` belongs with data-parallel training.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch


class Mesh:
    """A grid of ``torch.device``s with one name per axis.

    ``devices`` is a (nested) sequence whose depth is the number of axes;
    ``shape`` maps each axis name to its size, in order."""

    def __init__(self, devices, axis_names: Sequence[str]):
        names = tuple(axis_names)
        grid = np.empty(np.shape(np.asarray(devices, dtype=object)), dtype=object)
        flat = [torch.device(d) for d in np.asarray(devices, dtype=object).reshape(-1)]
        if grid.ndim != len(names) or not 1 <= grid.ndim <= 2 or not flat:
            raise ValueError(
                f"a mesh is a 1-D or 2-D grid with a name per axis; got shape"
                f" {grid.shape} for axes {names}"
            )
        if len(set(names)) != len(names):
            raise ValueError(f"axis names must differ: {names}")
        grid.reshape(-1)[:] = flat
        self.devices = grid
        self.axis_names = names
        self.shape = dict(zip(names, grid.shape))

    @property
    def size(self) -> int:
        return self.devices.size

    def _key(self):
        return self.axis_names, tuple(str(d) for d in self.devices.reshape(-1)), self.devices.shape

    def __eq__(self, other) -> bool:
        return isinstance(other, Mesh) and self._key() == other._key()

    def __hash__(self) -> int:
        return hash(self._key())

    def __repr__(self) -> str:
        return f"Mesh({self.devices.tolist()}, axis_names={self.axis_names})"


def make_mesh(num_devices: Optional[int] = None, axis_name: str = "data") -> Mesh:
    """A 1-D mesh over the first ``num_devices`` CUDA devices (default: all).

    Raises ValueError when fewer CUDA devices exist, as the JAX package
    raises beyond ``jax.devices()``: no mesh falls back to the CPU. A mesh of
    CPU shards, or of one card repeated, is :class:`Mesh` given its
    devices."""
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    n = have if num_devices is None else num_devices
    if n < 1 or n > have:
        raise ValueError(f"requested {n} CUDA devices, have {have}")
    return Mesh([torch.device("cuda", i) for i in range(n)], (axis_name,))


def split_batch(x: torch.Tensor, devices: Sequence[torch.device]) -> List[torch.Tensor]:
    """x split along its leading axis into contiguous slices, one per
    device (sizes differing by at most one), each moved to its device.
    Slices may be empty when x has fewer rows than devices."""
    return [part.to(dev) for part, dev in zip(torch.tensor_split(x, len(devices)), devices)]


def gather_batch(parts: Sequence[torch.Tensor], device) -> torch.Tensor:
    """The slices of :func:`split_batch` joined in order on ``device``."""
    return torch.cat([p.to(device) for p in parts])


def mesh_axes(mesh: Mesh, axis_name: str) -> Tuple[str, Optional[str]]:
    """(spatial axis, batch axis or None) of a 1-D mesh or a 2-D one with
    ``axis_name`` and one batch axis (``fast_srgan_tpu/parallel/spatial.py``
    ``_resolve_mesh_axes``)."""
    if axis_name in mesh.axis_names:
        sp = axis_name
    elif len(mesh.axis_names) == 1:
        (sp,) = mesh.axis_names
    else:
        raise ValueError(f"mesh axes {mesh.axis_names} contain no spatial axis {axis_name!r}")
    rest = tuple(a for a in mesh.axis_names if a != sp)
    return sp, (rest[0] if rest else None)
