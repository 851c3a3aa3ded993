"""The one-process shard mesh: the port's counterpart of
``shine_tpu/parallel/mesh.py``.

The JAX package runs its sharded paths as one SPMD program over a 1-D
device mesh; its tests hold an 8-device mesh on one CPU. The port keeps the
mesh in one process too: a mesh is a list of S devices, one a shard, where
a device may repeat. Four or eight shards can therefore stack on one card,
eight shards run on the CPU in the tests, and a host with several cards
puts one shard on each.

A shard's state is one entry of a per-shard list. This module holds the
only code that moves tensors between shards: ``all_gather``, ``psum``,
``psum_scatter`` and ``all_to_all`` over such lists, as ``jax.lax`` defines
them with ``tiled=True``. Shards on one device share a concatenation, a sum
or an index copy; shards on other devices receive peer copies. The one
read that reaches the host, ``host_sum``, is counted in ``readbacks``.
"""

from __future__ import annotations

import torch

from shine_tpu_torch.device import resolve_device


class ShardMesh:
    """S shards, shard s on ``devices[s]``."""

    def __init__(self, devices: list[torch.device]):
        if not devices:
            raise ValueError("a mesh needs at least one device")
        self.devices = [_indexed(d) for d in devices]
        self.readbacks = 0

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def one_device(self) -> bool:
        return all(d == self.devices[0] for d in self.devices)

    def describe(self) -> list[str]:
        """The devices as strings, shard by shard (the CLI's ``meta``)."""
        return [str(d) for d in self.devices]

    def put(self, parts: list[torch.Tensor]) -> list[torch.Tensor]:
        """Each part on its shard's device."""
        return [p.to(d) for p, d in zip(parts, self.devices)]

    def per_device(self, fn) -> list:
        """``fn(s)`` once a distinct device, s the first shard on it: one
        entry a shard, shared by the shards that sit on one device (a
        replicated computation such as a routing plan)."""
        done: dict = {}
        for s, d in enumerate(self.devices):
            if d not in done:
                done[d] = fn(s)
        return [done[d] for d in self.devices]

    def replicate(self, t: torch.Tensor) -> list[torch.Tensor]:
        """``t`` on every shard: one copy a distinct device, shared by the
        shards that sit on it."""
        return self.per_device(lambda s: t.to(self.devices[s]))

    def scatter(self, t: torch.Tensor) -> list[torch.Tensor]:
        """Split ``t`` along dim 0 into S equal slices, slice s to shard s."""
        n = t.shape[0]
        if n % self.size:
            raise ValueError(f"{n} rows do not split over {self.size} shards")
        per = n // self.size
        return [t[s * per:(s + 1) * per].to(d).contiguous()
                for s, d in enumerate(self.devices)]

    def all_gather(self, parts: list[torch.Tensor]) -> list[torch.Tensor]:
        """Every shard gets the parts concatenated along dim 0."""
        self._check(parts)
        if self.one_device:
            full = torch.cat(parts, 0)
            return [full] * self.size
        return [torch.cat([p.to(d) for p in parts], 0) for d in self.devices]

    def psum(self, parts: list[torch.Tensor]) -> list[torch.Tensor]:
        """Every shard gets the sum of the parts, in shard order."""
        self._check(parts)
        if self.one_device:
            total = torch.stack(parts).sum(0, dtype=parts[0].dtype)
            return [total] * self.size
        return [self._sum([p.to(d) for p in parts]) for d in self.devices]

    def psum_scatter(self, parts: list[torch.Tensor]) -> list[torch.Tensor]:
        """Shard r gets slice r (dim 0, S equal slices) of the parts' sum."""
        self._check(parts)
        S = self.size
        n = parts[0].shape[0]
        if n % S:
            raise ValueError(f"{n} rows do not split over {S} shards")
        per = n // S
        if self.one_device:
            total = torch.stack(parts).sum(0, dtype=parts[0].dtype)
            return [total[r * per:(r + 1) * per] for r in range(S)]
        return [self._sum([p[r * per:(r + 1) * per].to(d) for p in parts])
                for r, d in enumerate(self.devices)]

    def all_to_all(self, parts: list[torch.Tensor]) -> list[torch.Tensor]:
        """Each part is (S, ...): block j of shard i becomes block i of
        shard j."""
        self._check(parts)
        S = self.size
        if parts[0].shape[0] != S:
            raise ValueError(f"all_to_all parts need a leading dim of {S}")
        if self.one_device:
            x = torch.stack(parts).transpose(0, 1).contiguous()
            return list(x.unbind(0))
        return [torch.stack([p[j].to(d) for p in parts])
                for j, d in enumerate(self.devices)]

    def host_sum(self, parts: list[torch.Tensor]) -> int:
        """The sum of per-shard integer scalars, read to the host: the
        lockstep flag of a loop that every shard runs together."""
        self.readbacks += 1
        return int(torch.stack([p.to(self.devices[0]) for p in parts]).sum())

    def _check(self, parts: list[torch.Tensor]) -> None:
        if len(parts) != self.size:
            raise ValueError(f"{len(parts)} parts for {self.size} shards")

    @staticmethod
    def _sum(xs: list[torch.Tensor]) -> torch.Tensor:
        acc = xs[0].clone()
        for x in xs[1:]:
            acc += x
        return acc


def _indexed(d: torch.device | str) -> torch.device:
    """``d`` with its index: a bare ``cuda`` names the current card."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


def shard_mesh(
    n: int, *, device: torch.device | str | None = None,
    devices: list[torch.device | str] | None = None,
) -> ShardMesh:
    """A mesh of ``n`` shards. ``devices`` gives the list as it is;
    otherwise ``device="cpu"`` puts every shard on the CPU, another device
    puts every shard there, and ``None`` puts shard s on
    ``cuda:{s % device_count}`` (raises without a card)."""
    if devices is not None:
        if len(devices) != n:
            raise ValueError(f"{len(devices)} devices for {n} shards")
        devs = [torch.device(d) for d in devices]
        for d in devs:
            resolve_device(d)
        return ShardMesh(devs)
    if n < 1:
        raise ValueError("a mesh needs at least one shard")
    if device is None:
        resolve_device(None)
        count = torch.cuda.device_count()
        return ShardMesh([torch.device("cuda", s % count) for s in range(n)])
    dev = resolve_device(device)
    return ShardMesh([dev] * n)
