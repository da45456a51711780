"""Device meshes: the port of `victor_tpu/parallel/mesh.py`.

The reference's only multiprocess facility is `mpirun -n N cobaya-run`: N
independent chains that communicate only for the Gelman-Rubin check
(victor/README.md:30). victor_tpu replaces it with a `jax.sharding.Mesh`:
the tables are replicated, the batch of parameter points is sharded, and
XLA partitions the program. PyTorch has no partitioner, so here a `Mesh`
is an array of `torch.device`s with named axes, and `shard_map` does by
hand what the sharded jit does: it splits a batch along the axes it is
given, evaluates every slice on its device with that device's replica of
the tables, and gathers the results on the caller's device. Slices are
evaluated in chunks issued in turn across the devices (chunk k of every
slice before chunk k + 1 of any), so that no device's launch queue holds
the host while the others wait, and nothing is read back before every
chunk is issued. No collective is needed in the forward pass; autograd
flows back through the copies to every shard.

A mesh may name one device more than once (`make_mesh(devices=['cpu'] *
8)`, or `[cuda:0, cuda:0]` on a one-card machine), which a JAX mesh cannot:
it is how a single device runs the sharded code paths, as victor_tpu's
tests do on `--xla_force_host_platform_device_count=8` virtual devices.

Across processes, `distributed_init` joins a `torch.distributed` process
group and `cross_chain_rhat(..., group=...)` gathers the per-chain
statistics of chains split over the processes (`parallel/probe.py` runs
both).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils.profiling import device_index, span


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """Named axes over an object array of `torch.device`s in the mesh's
    shape (`devices`), with JAX's `shape` (name -> size), `shape_tuple`
    ((name, size) pairs) and `size`."""
    devices: np.ndarray
    axis_names: Tuple[str, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def shape_tuple(self) -> Tuple[Tuple[str, int], ...]:
        return tuple(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)


def distributed_init(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: Optional[str] = None) -> None:
    """Join a multi-process `torch.distributed` group; a no-op for one
    process.

    Call once at program start in each process, with the same coordinator
    ('host:port') everywhere; process 0 listens there. `backend` None gives
    torch's default (gloo for CPU tensors, NCCL for CUDA tensors); NCCL
    refuses two ranks on one GPU, so processes that share a card pass
    'gloo'."""
    if num_processes is None or num_processes <= 1:
        if coordinator_address is not None and num_processes is None:
            # a coordinator with no process count is a misconfigured
            # multi-process launch: failing fast beats N processes silently
            # running independent single-process programs
            raise ValueError(
                'distributed_init: coordinator_address was given but '
                'num_processes is None — pass the process count (and '
                'process_id) for a multi-process launch')
        return
    import torch.distributed as dist
    dist.init_process_group(
        backend=backend, init_method=f'tcp://{coordinator_address}',
        world_size=num_processes,
        rank=-1 if process_id is None else process_id)


def make_mesh(axis_names: Sequence[str] = ('chains', 'walkers'),
              shape: Optional[Tuple[int, ...]] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """A mesh over `devices`, by default every CUDA device.

    Without `devices` and without a CUDA device it raises: the port never
    falls back to the CPU, whose mesh is asked for by name
    (`devices=['cpu'] * n`). If `shape` is omitted, the devices are
    factored as victor_tpu does: the largest factor on the last axis
    (walkers), middle axes singleton — 8 devices give (2, 4) on two axes
    and (2, 1, 4) on three."""
    if devices is None:
        n = torch.cuda.device_count()
        if n == 0:
            raise RuntimeError(
                'make_mesh: no CUDA device; pass devices=, e.g. '
                "devices=['cpu'] * 8, for a mesh on the host")
        devices = [torch.device('cuda', i) for i in range(n)]
    devices = [torch.device(d) for d in devices]
    if len({d.type for d in devices}) > 1:
        raise ValueError('make_mesh: the devices must be of one type; got '
                         f'{sorted({d.type for d in devices})}')
    n = len(devices)
    if shape is None:
        a = 1
        if len(axis_names) > 1:
            for cand in range(int(math.isqrt(n)), 0, -1):
                if n % cand == 0:
                    a = cand
                    break
        shape = (a,) + (1,) * (len(axis_names) - 2) + (n // a,) \
            if len(axis_names) > 1 else (n,)
    if int(np.prod(shape)) != n or len(shape) != len(axis_names):
        raise ValueError(f'mesh shape {tuple(shape)} does not cover {n} '
                         f'devices on the axes {tuple(axis_names)}')
    arr = np.empty(n, dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(tuple(shape)), tuple(axis_names))


def _axes(mesh: Mesh, axes) -> Tuple[str, ...]:
    names = tuple(mesh.axis_names) if axes is None else \
        (axes,) if isinstance(axes, str) else tuple(axes)
    unknown = [a for a in names if a not in mesh.axis_names]
    if unknown:
        raise ValueError(f'mesh axes {unknown} are not among '
                         f'{mesh.axis_names}')
    return names


def shard_devices(mesh: Mesh, axes=None) -> list:
    """The device of each slice when a batch is split along the mesh axes
    `axes` (a name, a tuple of names, or None for all): one per position of
    those axes, row-major, the other axes at their first position (JAX
    replicates over them)."""
    names = _axes(mesh, axes)
    order = [mesh.axis_names.index(a) for a in names]
    rest = [i for i in range(len(mesh.axis_names)) if i not in order]
    devs = np.transpose(mesh.devices, order + rest)
    devs = devs[(...,) + (0,) * len(rest)] if rest else devs
    return list(devs.reshape(-1))


def shard_along(x: torch.Tensor, mesh: Mesh, axes: Sequence):
    """What `jax.device_put(x, NamedSharding(mesh, PartitionSpec(*axes)))`
    places on each device: an object array in the mesh's shape whose entry
    at each position is that position's slice of `x`, on its device. Entry
    i of `axes` names the mesh axis (or tuple of axes, or None) that splits
    dimension i of `x`, which must divide evenly."""
    out = np.empty(mesh.devices.shape, dtype=object)
    for pos in np.ndindex(*mesh.devices.shape):
        index = []
        for dim, ax in enumerate(axes):
            if ax is None:
                index.append(slice(None))
                continue
            names = _axes(mesh, ax)
            sizes = [mesh.shape[a] for a in names]
            k = int(np.prod(sizes))
            if x.shape[dim] % k:
                raise ValueError(f'dimension {dim} of size {x.shape[dim]} '
                                 f'does not split evenly over {k} devices')
            at = int(np.ravel_multi_index(
                [pos[mesh.axis_names.index(a)] for a in names], sizes))
            step = x.shape[dim] // k
            index.append(slice(at * step, (at + 1) * step))
        out[pos] = x[tuple(index)].to(mesh.devices[pos])
    return out


def _first_tensor(x) -> Optional[torch.Tensor]:
    """The first tensor found in `x` (a tensor, a dataclass, a tuple, list
    or dict of them, or None)."""
    if isinstance(x, torch.Tensor):
        return x
    if dataclasses.is_dataclass(x):
        x = [getattr(x, f.name) for f in dataclasses.fields(x)]
    elif isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (tuple, list)):
        for v in x:
            t = _first_tensor(v)
            if t is not None:
                return t
    return None


def _to(x, device: torch.device):
    """`x` on `device`: tensors and containers of them, and objects with a
    `.to(device, dtype)` (bundles, tables), which keep their dtype."""
    if x is None or isinstance(x, torch.Tensor):
        return x if x is None else x.to(device)
    if isinstance(x, (tuple, list)):
        return type(x)(_to(v, device) for v in x)
    if isinstance(x, dict):
        return {k: _to(v, device) for k, v in x.items()}
    ref = _first_tensor(x)
    if ref is None or ref.device == device:
        return x
    return x.to(device, ref.dtype)


def replicate(x, mesh: Mesh) -> dict:
    """One copy of `x` per distinct device of `mesh`, {device: copy}: a
    tensor, a container of them, or a bundle (`CCFModelBundle.to`,
    `JointBundle.to`). A device that already holds `x` gets `x` itself."""
    return {d: _to(x, d) for d in dict.fromkeys(mesh.devices.flat)}


def _on(device: torch.device):
    return torch.cuda.device(device) if device.type == 'cuda' \
        else contextlib.nullcontext()


def _pieces(x: torch.Tensor, chunk: Optional[int]) -> list:
    """x as `chunked` evaluates it: whole when it has no more than `chunk`
    rows (or chunk is None), else chunks of `chunk` rows, the last padded
    with copies of x's first row so that every chunk has one shape."""
    n = x.shape[0]
    if not chunk or n <= chunk:
        return [x]
    n_chunks = -(-n // chunk)
    pad = n_chunks * chunk - n
    if pad:
        x = torch.cat([x, x[:1].expand(pad, *x.shape[1:])])
    return [x[i * chunk:(i + 1) * chunk] for i in range(n_chunks)]


def _join(outs: list, n: int):
    """The pieces' results (each a tensor or a tuple of them) as one
    result of n rows, the pad rows dropped."""
    if len(outs) == 1:
        return outs[0]
    if isinstance(outs[0], torch.Tensor):
        return torch.cat(outs)[:n]
    return tuple(torch.cat(o)[:n] for o in zip(*outs))


def _chunk_span(device: torch.device) -> str:
    """The name of the span of each chunk issued to `device`,
    `likelihood.chunk#<device index>`."""
    return f'likelihood.chunk#{device_index(device)}'


def chunked(run, chunk: Optional[int]):
    """`run(x) -> a tensor or tuple of (N, ...) tensors`, evaluated in
    chunks of `chunk` rows when the batch is larger (`_pieces`); the pad
    rows are discarded. None evaluates the whole batch at once. Each chunk
    runs in a `likelihood.chunk#<i>` span (`utils.profiling`)."""
    def fn(x):
        name = _chunk_span(x.device)
        outs = []
        for p in _pieces(x, chunk):
            with span(name):
                outs.append(run(p))
        return _join(outs, x.shape[0])
    return fn


def shard_map(fn, tables, mesh: Optional[Mesh], axes=None,
              chunk: Optional[int] = None):
    """`x -> fn(tables, x)` in chunks of `chunk` rows, with the batch split
    over `mesh`.

    `fn(tbl, x)` returns a tensor or a tuple of tensors whose leading axis
    is x's. With a mesh, the tables are replicated once per distinct device
    now; each call splits x into one slice per position of the mesh axes
    `axes` (`shard_devices`; sizes differ by at most one, as `tensor_split`
    makes them), cuts each slice into chunks as `chunked` does, issues
    chunk k of every slice, each on its device with that device's replica
    under `torch.cuda.device` (so the kernels launch on that device's
    current stream), before chunk k + 1 of any, and only then gathers the
    results onto x's device, in order. Without a mesh, `chunked(x ->
    fn(tables, x), chunk)`. Spans (`utils.profiling`): `mesh.scatter`
    around the slices' copies, `likelihood.chunk#<i>` around each chunk
    issued to device i, `mesh.gather` around the copies back and the joins.

    The tables, the mesh and x must lie on one device type: a copy between
    the host and a card is never made silently."""
    if mesh is None:
        return chunked(lambda x: fn(tables, x), chunk)
    devices = shard_devices(mesh, axes)
    kind = devices[0].type
    ref = _first_tensor(tables)
    if ref is not None and ref.device.type != kind:
        raise ValueError(f'shard_map: the tables lie on {ref.device} but the '
                         f'mesh on {kind} devices')
    replicas = replicate(tables, mesh)

    def call(x):
        if x.device.type != kind:
            raise ValueError(f'shard_map: the batch lies on {x.device} but '
                             f'the mesh on {kind} devices')
        bounds = np.cumsum([0] + [len(a) for a in np.array_split(
            np.arange(x.shape[0]), len(devices))])
        with span('mesh.scatter'):
            slices = [(d, x[a:b].to(d)) for d, a, b in
                      zip(devices, bounds[:-1], bounds[1:]) if b > a]
        pieces = [_pieces(part, chunk) for _, part in slices]
        names = [_chunk_span(d) for d, _ in slices]
        outs = [[] for _ in slices]
        for k in range(max(len(p) for p in pieces)):
            for (d, _), p, out, name in zip(slices, pieces, outs, names):
                if k < len(p):
                    with _on(d), span(name):
                        out.append(fn(replicas[d], p[k]))
        with span('mesh.gather'):
            parts = [_join(out, part.shape[0])
                     for out, (_, part) in zip(outs, slices)]
            if isinstance(parts[0], torch.Tensor):
                return torch.cat([p.to(x.device) for p in parts])
            return tuple(torch.cat([p[j].to(x.device) for p in parts])
                         for j in range(len(parts[0])))

    return call


def _all_gather(t: torch.Tensor, group) -> torch.Tensor:
    """`t` from every process of `group`, stacked in rank order. Under gloo
    a CUDA tensor travels as a host copy (gloo gathers host memory; NCCL,
    which gathers device memory, refuses two ranks on one card)."""
    import torch.distributed as dist
    host = dist.get_backend(group) == 'gloo' and t.is_cuda
    src = t.cpu() if host else t
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src.contiguous(), group=group)
    return torch.stack(parts).to(t.device)


def cross_chain_rhat(chains_by_param: torch.Tensor, group=None):
    """Split-R-hat over a (n_chains, n_draws, n_params) tensor.

    With `group` (a `torch.distributed` process group, e.g.
    `torch.distributed.group.WORLD`), each process passes its own chains
    (the same count and draws everywhere) and the per-chain means and
    variances are gathered over the group in rank order: the Gelman-Rubin
    check across processes that the reference's MPI chains make, through
    real collectives. The result is the same on every process."""
    x = chains_by_param
    n = x.shape[1]
    half = n // 2
    if half < 2:
        # fewer than 2 draws per split half: R-hat is undefined — report
        # "not converged" rather than dividing by n = 0
        return torch.full(x.shape[2:], math.inf, dtype=x.dtype,
                          device=x.device)
    parts = (x[:, :half], x[:, half:2 * half])          # split chains
    means = [p.mean(dim=1) for p in parts]              # (m, P) each
    variances = [p.var(dim=1, correction=1) for p in parts]
    if group is not None:
        means = [_all_gather(t, group).flatten(0, 1) for t in means]
        variances = [_all_gather(t, group).flatten(0, 1) for t in variances]
    chain_mean = torch.cat(means)                       # (2m, P)
    chain_var = torch.cat(variances)
    n = half
    B = n * chain_mean.var(dim=0, correction=1)
    W = chain_var.mean(dim=0)
    var_post = (n - 1) / n * W + B / n
    # W == 0 (every chain constant — a stuck sampler) would give NaN, which
    # fails every `rhat - 1 < stop` test silently; +inf says "not converged"
    bad = W <= 0
    return torch.where(bad, math.inf,
                       torch.sqrt(var_post / torch.where(bad, 1.0, W)))
