"""Data-parallel training over ray shards (port of umhs_tpu/parallel/mesh.py).

The JAX package runs every train step inside `shard_map` over a 1-D mesh of
all chips: parameters, optimizer state, the occupancy grid and the images
are replicated; each chip marches, shades and differentiates its contiguous
shard of the ray batch; then one `pmean` of the loss, its terms, the metrics
and every gradient (a `psum` for the metrics named `*_per_batch`, which are
counts) is the step's only collective (mesh.py:53-136). Eval and render
shard the rays the same way with no collective at all (mesh.py:139-168).

Here the mesh is one process per rank, `torch.distributed` between them:

- `make_mesh` names this process's rank, the world size, the process group,
  the device and the backend (`nccl` between cards; `gloo` by name only,
  for the CPU tests and for two ranks on one card, which NCCL refuses).
  World size 1 needs no group.
- `shard_rays` / `shard_draws` cut a batch, or one step's draws, to this
  rank's contiguous shard. Every rank draws the whole batch from the same
  generator, so a step over N ranks and a step in one process take the same
  draws and compute the same function (only the order of the sums differs).
  This stands in for the JAX step's `fold_in(key, axis_index)`.
- `local_budget` is each stage's compact budget on one rank,
  max(256, b // N) (mesh.py:68-74).
- `reduce_step` is the step's one collective: every gradient, the loss, its
  terms and the metrics in one flat float32 buffer, one `all_reduce`.
- `put_replicated` broadcasts state from rank 0 (trainer.py:403-408,
  1401-1404).
- `make_eval_forward` runs a forward on this rank's shard of the rays and
  gathers every output (one `all_reduce` of the outputs' bytes).
- `launch` starts one process per rank (torch.multiprocessing, spawn) with a
  rendezvous on localhost and returns each rank's result; a rank that fails
  makes it raise. `state_digest` lets the launcher hold the ranks' final
  states to one another, bit for bit.
"""

from __future__ import annotations

import dataclasses
import hashlib
import math
import socket
import tempfile
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank of a 1-D data-parallel mesh over every rank of the default
    process group. `backend` and `group` are None for world size 1 without a
    process group (no collective runs)."""

    rank: int
    size: int
    device: torch.device
    backend: Optional[str] = None
    group: Any = None

    @property
    def is_main(self) -> bool:
        return self.rank == 0


def make_mesh(device="cuda") -> Mesh:
    """The mesh of this process on `device`: every rank of the default
    process group once torch.distributed is initialised, else world size 1
    with no group."""
    device = torch.device(device)
    if not dist.is_initialized():
        return Mesh(0, 1, device)
    return Mesh(dist.get_rank(), dist.get_world_size(), device, dist.get_backend(),
                dist.group.WORLD)


def local_budget(budget: Union[int, Sequence[int]], n: int):
    """Each stage's compact budget on one of `n` ranks: max(256, b // n)
    (mesh.py:68-74), for one budget or a tuple of them."""
    if isinstance(budget, (tuple, list)):
        return tuple(max(256, int(b) // n) for b in budget)
    return max(256, int(budget) // n)


def shard_rays(tree, mesh: Mesh, dim: int = 0):
    """This rank's contiguous shard, along `dim`, of every tensor in a dict,
    tuple or list (None passes through). Raises unless the length divides
    the world size: the shards are equal, so the mean of the shards' means
    is the mean of the batch."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: shard_rays(v, mesh, dim) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(shard_rays(v, mesh, dim) for v in tree)
    n = tree.shape[dim]
    if n % mesh.size:
        raise ValueError(f"{n} rays do not split over {mesh.size} ranks")
    m = n // mesh.size
    return tree.narrow(dim, mesh.rank * m, m)


def shard_draws(draws: Dict[str, object], mesh: Mesh) -> Dict[str, object]:
    """This rank's shard of one step's draws: the pixels (or, with patches,
    the patch anchors, so that every patch stays whole in one shard), the
    march jitter (R,), the background (R, 3) and the proposal sampler's
    jitters (P + 1, R, 1) along R."""
    return {k: shard_rays(v, mesh, dim=1 if k == "prop_jitter" else 0)
            for k, v in draws.items()}


def check_shardable(rays: int, patch_size: int, n: int) -> None:
    """Raise unless `rays` rays, and every ray count the dynamic batching can
    pick (multiples of lcm(256, patch^2)), split into `n` equal shards of
    whole patches."""
    p2 = max(patch_size, 1) ** 2
    align = math.lcm(256, p2)
    for count in (rays, align):
        if count % (n * p2):
            raise ValueError(f"{count} rays in patches of {p2} do not split over {n} ranks; "
                             f"the ray count and lcm(256, patch^2) must divide by {n} x {p2}")


def reduce_step(mesh: Mesh, grads: Sequence[torch.Tensor],
                values: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The step's one collective (mesh.py:108-119): each gradient in
    `grads` (float32, reduced in place), and the 0-d `values` (the total
    loss, its terms, the metrics) become their means over the ranks, except
    the values named `*_per_batch`, which are counts and become sums.

    Everything goes into one flat float32 buffer: the gradients, then the
    means, then the counts in a slice of their own; one all_reduce sums it;
    the gradients' and the means' part is divided by the world size (as
    pmean divides its psum) and the counts' part is left as the sum. The
    counts are integers below 2^24 (at most 2^17 rays x 64 samples per
    stage), so their float32 sum is exact. At world size 1 the sum over one
    rank and the division by 1 change no bit. Returns the reduced values as
    0-d tensors, by name, in the order of `values`."""
    counts = [k for k in values if k.endswith("_per_batch")]
    means = [k for k in values if not k.endswith("_per_batch")]
    for g in grads:
        if g.dtype != torch.float32:
            raise TypeError(f"reduce_step takes float32 gradients, not {g.dtype}")
    scalars = [torch.as_tensor(values[k], dtype=torch.float32, device=mesh.device).reshape(1)
               for k in means + counts]
    flat = torch.cat([g.reshape(-1) for g in grads] + scalars)
    if mesh.backend is not None:
        dist.all_reduce(flat, group=mesh.group)
    n_mean = sum(g.numel() for g in grads) + len(means)
    flat[:n_mean].div_(mesh.size)
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()
    reduced = dict(zip(means + counts, flat[offset:].unbind()))
    return {k: reduced[k] for k in values}


def put_replicated(tensors: Sequence[torch.Tensor], mesh: Mesh) -> None:
    """Make every tensor rank 0's, in place (a broadcast each); a no-op
    without a group. The tensors must lie on the mesh's device."""
    if mesh.backend is None:
        return
    for t in tensors:
        dist.broadcast(t, 0, group=mesh.group)


def barrier(mesh: Mesh) -> None:
    """Wait for every rank (a no-op without a group)."""
    if mesh.backend is not None:
        dist.barrier(group=mesh.group)


def gather_rays(outputs: Dict[str, torch.Tensor], mesh: Mesh) -> Dict[str, torch.Tensor]:
    """Every rank's per-ray outputs (each rank's shard along dim 0, equal
    shapes on every rank) concatenated in rank order, on every rank.

    One all_reduce of a zeroed uint8 buffer in which each rank writes its
    outputs' bytes at its own offset: a sum of bytes with zeros keeps every
    bit (-0.0 and NaNs too), and it works on every backend, gloo on CUDA
    tensors included, which has no all_gather."""
    names = list(outputs)
    local = [outputs[k].contiguous() for k in names]
    sizes = [t.numel() * t.element_size() for t in local]
    buf = torch.zeros((mesh.size, sum(sizes)), dtype=torch.uint8, device=mesh.device)
    offset = 0
    for t, nb in zip(local, sizes):
        buf[mesh.rank, offset:offset + nb] = t.reshape(-1).view(torch.uint8)
        offset += nb
    dist.all_reduce(buf, group=mesh.group)
    out, offset = {}, 0
    for k, t, nb in zip(names, local, sizes):
        part = buf[:, offset:offset + nb].contiguous().view(t.dtype)
        out[k] = part.reshape(mesh.size * t.shape[0], *t.shape[1:])
        offset += nb
    return out


def state_digest(tensors: Dict[str, torch.Tensor]) -> str:
    """sha1 of every tensor's name and bytes, in name order: replicas with
    equal digests hold equal bits."""
    h = hashlib.sha1()
    for name in sorted(tensors):
        h.update(name.encode())
        t = tensors[name].detach().cpu().contiguous().reshape(-1)
        h.update(t.view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def make_eval_forward(forward: Callable[..., Dict[str, torch.Tensor]], mesh: Optional[Mesh]):
    """The inference forward, ray-sharded over the mesh (mesh.py:139-168):
    fwd(rays, prop_jitter=None) -> outputs of every ray, on every rank.

    `forward(rays, prop_jitter)` renders rays (R, ...) with the proposal
    sampler's jitters (P + 1, R, 1) or None. With two ranks or more and a
    ray count that divides the world size, each rank renders its shard (its
    slice of the jitters too) and the outputs are gathered; otherwise every
    rank renders every ray, as trainer.py:1216-1222 does."""

    def fwd(rays: Dict[str, torch.Tensor], prop_jitter: Optional[torch.Tensor] = None):
        n = next(iter(rays.values())).shape[0]
        if mesh is None or mesh.size == 1 or n % mesh.size:
            return forward(rays, prop_jitter)
        out = forward(shard_rays(rays, mesh), shard_rays(prop_jitter, mesh, dim=1))
        return gather_rays(out, mesh)

    return fwd


# ---------------------------------------------------------------------------
# one process per rank
# ---------------------------------------------------------------------------

def free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def init_mesh(rank: int, world_size: int, backend: str, device, init_method: str) -> Mesh:
    """Join the default process group as `rank` of `world_size` on `device`
    with `backend` (named, never chosen here) and return the mesh."""
    device = torch.device(device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size)
    return make_mesh(device)


def close_mesh(mesh: Mesh) -> None:
    """Leave the default process group, if the mesh has one."""
    if mesh.backend is not None and dist.is_initialized():
        dist.destroy_process_group()


def _rank_main(rank: int, fn: Callable, world_size: int, backend: str, devices: Sequence[str],
               init_method: str, args: Tuple, result_dir: str) -> None:
    mesh = init_mesh(rank, world_size, backend, devices[rank], init_method)
    try:
        result = fn(mesh, *args)
    finally:
        close_mesh(mesh)
    torch.save(result, Path(result_dir) / f"rank{rank}.pt")


def launch(fn: Callable, world_size: int, backend: str, devices: Sequence[str],
           args: Tuple = (), init_method: Optional[str] = None) -> List[Any]:
    """Run fn(mesh, *args) in `world_size` new processes, rank r on
    devices[r], joined by `backend` through `init_method` (a TCP rendezvous
    on a free localhost port when None). `fn` must be importable by name (it
    crosses a spawn) and return something torch.save can write. Returns the
    ranks' results in rank order; raises when a rank raises or dies (the
    others are then stopped)."""
    if len(devices) != world_size:
        raise ValueError(f"{len(devices)} devices for {world_size} ranks")
    init_method = init_method or f"tcp://127.0.0.1:{free_port()}"
    with tempfile.TemporaryDirectory(prefix="umhs_ranks_") as result_dir:
        torch.multiprocessing.spawn(
            _rank_main, args=(fn, world_size, backend, list(devices), init_method, args,
                              result_dir),
            nprocs=world_size, join=True)
        return [torch.load(Path(result_dir) / f"rank{r}.pt", weights_only=False)
                for r in range(world_size)]
