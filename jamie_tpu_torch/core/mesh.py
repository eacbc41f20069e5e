"""Device mesh, row padding, tensor-parallel rules and collectives.

Reference parity: `jamie_tpu/core/mesh.py` (`create_mesh`, `data_sharding`,
`replicated_sharding`, `axis_size`, `pad_rows_to_axis`, `shard_rows`,
`model_axis_size`, `param_spec`, `shard_params_tree`, :20-125). jamie_tpu's
mesh is single-controller GSPMD: one program, shardings as annotations.
Here it is `torch.distributed`: one process per device, a `DeviceMesh`
with the named dims ('data',) or ('data', 'model') over the default process
group, and every rank calls the same entry point with the same inputs
(SPMD). The collectives are explicit, on local blocks, so the hand kernels
run on each rank's shard.

Processes come from `torchrun --nproc-per-node=N` or from `spawn_local`
below. `create_mesh((1,), ...)` in a process without a group starts a
world-size-1 group itself (NCCL on the card, gloo on the CPU).

The autograd-aware collectives come in two conventions:

- the 'data' axis splits batch rows; each rank's loss is the sum over its
  own rows, and the collectives are exact adjoints of their forward maps
  (`all_reduce`: backward all-reduce; `all_gather`: backward
  reduce-scatter; `reduce_scatter`: backward all-gather), so the gradients
  summed over the data ranks are the gradients of the whole batch;
- the 'model' axis splits features (Megatron's convention): every model
  rank computes the same loss, and a replicated activation carries the
  same whole gradient on every model rank (`copy_to`: forward identity,
  backward all-reduce; `reduce_from`: forward all-reduce, backward
  identity; `scatter_to`: forward slice, backward all-gather;
  `gather_from`: forward all-gather, backward slice).

`torch.distributed.nn.functional.all_gather` is not used: its backward
fails on a DeviceMesh sub-group ("Global rank 0 is not part of group").
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import os
import shutil
import sys
import tempfile
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

DATA, MODEL = 'data', 'model'

# torch renamed the single-tensor collectives; the card's torch may have
# only the old names
_ALL_GATHER = getattr(dist, 'all_gather_single', None) \
    or dist.all_gather_into_tensor
_REDUCE_SCATTER = getattr(dist, 'reduce_scatter_single', None) \
    or dist.reduce_scatter_tensor

# The temporary directory of a world-size-1 group this module started
_OWN_GROUP_DIR: List[str] = []


def _backend(device_type: str) -> str:
    return 'nccl' if device_type == 'cuda' else 'gloo'


def init_local_group(device_type: Optional[str] = None) -> None:
    """Start a world-size-1 process group through a FileStore in a fresh
    temporary directory (NCCL for 'cuda', gloo for 'cpu'); no TCP port."""
    device_type = device_type or ('cuda' if torch.cuda.is_available()
                                  else 'cpu')
    if dist.is_initialized():
        raise RuntimeError('a process group is already initialized')
    tmp = tempfile.mkdtemp(prefix='jamie_mesh_')
    if device_type == 'cuda':
        torch.cuda.set_device(0)
    store = dist.FileStore(os.path.join(tmp, 'store'), 1)
    dist.init_process_group(_backend(device_type), store=store, rank=0,
                            world_size=1)
    _OWN_GROUP_DIR.append(tmp)


def destroy_group() -> None:
    """Destroy the default process group (and the temporary directory of
    one that `init_local_group` started)."""
    if dist.is_initialized():
        dist.destroy_process_group()
    while _OWN_GROUP_DIR:
        shutil.rmtree(_OWN_GROUP_DIR.pop(), ignore_errors=True)


def create_mesh(shape: Optional[Tuple[int, ...]] = None,
                axis_names: Tuple[str, ...] = (DATA,),
                devices: Optional[Sequence] = None,
                device_type: Optional[str] = None):
    """A DeviceMesh over the default process group.

    shape=None puts every rank on the first axis. A 1-sized mesh in a
    process with no group starts a world-size-1 group (init_local_group),
    so the same code path runs from one device up. Every rank must be in
    the mesh: the port is SPMD, and a rank outside it would have no part
    to play. device_type defaults to 'cuda' on an NCCL group, else 'cpu'.

    devices: jamie_tpu's device list, one `torch.device` (or its string)
    per rank in rank order. shape=None then takes its length, as in
    jamie_tpu, and only its first prod(shape) entries are used; they must
    be the ranks' own devices (one type, and on the card this rank's
    current device), else the ValueError jamie_tpu raises for a shape it
    cannot fill.
    """
    from torch.distributed.device_mesh import init_device_mesh
    axis_names = tuple(axis_names)
    if devices is not None:
        devices = [torch.device(d) for d in devices]
        if shape is None:
            shape = (len(devices),) + (1,) * (len(axis_names) - 1)
        n = math.prod(shape)
        if n > len(devices):
            raise ValueError(f'mesh shape {tuple(shape)} needs {n} devices, '
                             f'have {len(devices)}')
        devices = devices[:n]
        types = {d.type for d in devices}
        if len(types) != 1 or device_type not in (None, *types):
            raise ValueError(f'mesh shape {tuple(shape)} needs {n} devices, '
                             f'have {len(devices)} of types {sorted(types)}'
                             + (f' for a {device_type} mesh'
                                if device_type else ''))
        device_type = devices[0].type
    if not dist.is_initialized():
        want = 1 if shape is None else math.prod(shape)
        if want != 1:
            raise ValueError(f'mesh shape {tuple(shape)} needs {want} '
                             'devices, have 1 (no process group: launch '
                             'with torchrun or spawn_local)')
        init_local_group(device_type)
    world = dist.get_world_size()
    if shape is None:
        shape = (world,) + (1,) * (len(axis_names) - 1)
    shape = tuple(int(s) for s in shape)
    if len(shape) != len(axis_names):
        raise ValueError(f'mesh shape {shape} and axis names {axis_names} '
                         'differ in length')
    n = math.prod(shape)
    if n > world:
        raise ValueError(f'mesh shape {shape} needs {n} devices, have {world}')
    if n < world:
        raise ValueError(f'mesh shape {shape} covers {n} of {world} ranks; '
                         'every rank must be in the mesh')
    if device_type is None:
        device_type = 'cuda' if dist.get_backend() == 'nccl' else 'cpu'
    if devices is not None:
        mine = devices[dist.get_rank()]
        if (device_type == 'cuda' and mine.index is not None
                and mine.index != torch.cuda.current_device()):
            raise ValueError(f'mesh shape {shape} needs {n} devices, have '
                             f'rank {dist.get_rank()} on cuda:'
                             f'{torch.cuda.current_device()}, not {mine}')
    return init_device_mesh(device_type, shape, mesh_dim_names=axis_names)


def check_mesh(mesh) -> None:
    from torch.distributed.device_mesh import DeviceMesh
    if mesh is not None and not isinstance(mesh, DeviceMesh):
        raise TypeError(f'mesh must be a torch.distributed DeviceMesh '
                        f'(core.mesh.create_mesh), got {type(mesh).__name__}')


def data_sharding(mesh, ndim: int = 2, axis: str = DATA):
    """DTensor placements that shard dim 0 (cells / batch rows) over
    `axis` and replicate over the other mesh dims; `ndim` (the array's
    rank, a PartitionSpec's length in jamie_tpu) must be at least 1."""
    from torch.distributed.tensor import Replicate, Shard
    if ndim < 1:
        raise ValueError('a row sharding needs an array of rank >= 1')
    return tuple(Shard(0) if name == axis else Replicate()
                 for name in mesh.mesh_dim_names)


def replicated_sharding(mesh):
    from torch.distributed.tensor import Replicate
    return tuple(Replicate() for _ in mesh.mesh_dim_names)


def axis_size(mesh, axis: str) -> int:
    if mesh is None or axis not in (mesh.mesh_dim_names or ()):
        return 1
    return int(mesh.size(mesh.mesh_dim_names.index(axis)))


def axis_index(mesh, axis: str) -> int:
    """This rank's coordinate on `axis` (0 off the mesh)."""
    if mesh is None or axis not in (mesh.mesh_dim_names or ()):
        return 0
    return int(mesh.get_local_rank(axis))


def axis_group(mesh, axis: str):
    """The process group of this rank's line along `axis`, or None when
    the mesh has no such axis."""
    if mesh is None or axis not in (mesh.mesh_dim_names or ()):
        return None
    return mesh.get_group(axis)


def model_axis_size(mesh, axis: str = MODEL) -> int:
    return axis_size(mesh, axis)


def pad_rows_to_axis(x, n_dev: int):
    """Zero-pad the leading dim to a multiple of `n_dev`, returning
    (padded, pad); numpy arrays and tensors pad in kind. The canonical pad
    of every row-sharded placement: each rank then holds the same number
    of rows, and the pad rows are never sampled and are sliced off."""
    if n_dev <= 1:
        return x, 0
    pad = (-x.shape[0]) % n_dev
    if pad:
        if isinstance(x, np.ndarray):
            x = np.concatenate([x, np.zeros((pad,) + x.shape[1:], x.dtype)])
        else:
            x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
    return x, pad


def row_block(n_rows: int, mesh, axis: str = DATA) -> Tuple[int, int]:
    """(first global row, rows) of this rank's block of n_rows padded
    rows."""
    n_dev = axis_size(mesh, axis)
    b = -(-n_rows // n_dev)
    return axis_index(mesh, axis) * b, b


def shard_rows(mesh, x, axis: str = DATA):
    """This rank's block of x's rows over `axis`, after zero-padding the
    leading dim to the axis size (pad_rows_to_axis); in kind."""
    xp, _ = pad_rows_to_axis(x, axis_size(mesh, axis))
    start, b = row_block(x.shape[0], mesh, axis)
    return xp[start:start + b]


def param_spec(shape: Tuple[int, ...], n_model: int,
               wide_threshold: int = 1024) -> Optional[int]:
    """The tensor-parallel dim of one parameter by shape alone, or None
    (replicated). jamie_tpu's rule (:85-105): shard the LARGEST dim that
    is >= wide_threshold and divisible by the model-axis size, the later
    dim on a tie; 1-D vectors (bias, BatchNorm scale and stats) shard when
    they qualify too."""
    if n_model <= 1 or not shape:
        return None
    dims = [(d, i) for i, d in enumerate(shape)
            if d >= wide_threshold and d % n_model == 0]
    if not dims:
        return None
    return max(dims)[1]


def torch_param_spec(shape: Tuple[int, ...], n_model: int,
                     wide_threshold: int = 1024) -> Optional[int]:
    """param_spec for a torch tensor: a 2-D Linear weight is (out, in), the
    transpose of the flax kernel the rule was written for, so the rule is
    applied to the flax layout and the dim mapped back."""
    if len(shape) == 2:
        spec = param_spec(tuple(shape)[::-1], n_model, wide_threshold)
        return None if spec is None else 1 - spec
    return param_spec(tuple(shape), n_model, wide_threshold)


def local_shard(t: torch.Tensor, dim: Optional[int], n: int,
                index: int) -> torch.Tensor:
    """Rank `index`'s contiguous 1/n of t along dim (t itself for None)."""
    if dim is None or n <= 1:
        return t
    size = t.shape[dim] // n
    return t.narrow(dim, index * size, size).contiguous()


def shard_params_tree(module: torch.nn.Module, mesh,
                      wide_threshold: int = 1024,
                      axis: str = MODEL) -> Dict[str, Optional[int]]:
    """Slice every parameter and buffer of `module`, in place, to this
    rank's shard on the model axis by `torch_param_spec`; returns
    {name: sharded torch dim or None}. Build the optimizer after this call
    so that its moments (FlatClipAdam's mu/nu) are shards too."""
    n = model_axis_size(mesh, axis)
    k = axis_index(mesh, axis)
    specs = {}
    with torch.no_grad():
        for name, p in module.named_parameters():
            specs[name] = torch_param_spec(tuple(p.shape), n, wide_threshold)
            p.data = local_shard(p.data, specs[name], n, k)
        for mod_name, mod in module.named_modules():
            for b_name, b in list(mod.named_buffers(recurse=False)):
                name = f'{mod_name}.{b_name}' if mod_name else b_name
                specs[name] = torch_param_spec(tuple(b.shape), n,
                                               wide_threshold)
                setattr(mod, b_name, local_shard(b, specs[name], n, k))
    return specs


# --------------------------------------------------------------- splits
@dataclasses.dataclass(frozen=True)
class Split:
    """A dim of `sum(sizes)` entries split over `group`: this rank (index
    in the group) holds entries [start, stop) along `dim`."""
    group: object
    sizes: Tuple[int, ...]
    index: int
    dim: int = 0

    @property
    def total(self) -> int:
        return sum(self.sizes)

    @property
    def start(self) -> int:
        return sum(self.sizes[:self.index])

    @property
    def stop(self) -> int:
        return self.start + self.sizes[self.index]

    def local(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's part of a whole tensor (a view)."""
        return x.narrow(self.dim, self.start, self.sizes[self.index])


def split_of(total: int, mesh, axis: str, dim: int = 0) -> Split:
    """`total` entries over the mesh axis, the first total % n ranks one
    entry more (torch.tensor_split's sizes)."""
    n = axis_size(mesh, axis)
    sizes = tuple(total // n + (1 if r < total % n else 0) for r in range(n))
    return Split(axis_group(mesh, axis), sizes, axis_index(mesh, axis), dim)


def block_split(rows: int, mesh, axis: str = DATA) -> Split:
    """Equal blocks of `rows` rows on every rank of the axis (the padded
    row blocks of `shard_rows`)."""
    return Split(axis_group(mesh, axis), (int(rows),) * axis_size(mesh, axis),
                 axis_index(mesh, axis))


def _to_front(x: torch.Tensor, dim: int) -> torch.Tensor:
    return x.movedim(dim, 0).contiguous() if dim % x.dim() else x.contiguous()


def _from_front(x: torch.Tensor, dim: int) -> torch.Tensor:
    return x.movedim(0, dim) if dim % x.dim() else x


def _ar(x: torch.Tensor, group) -> torch.Tensor:
    y = x.contiguous().clone()
    dist.all_reduce(y, group=group)
    return y


def _ag(x: torch.Tensor, split: Split) -> torch.Tensor:
    """Concatenate every rank's part along split.dim (uneven parts are
    padded to the largest for the collective)."""
    n, big = len(split.sizes), max(split.sizes)
    x0 = _to_front(x, split.dim)
    if x0.shape[0] < big:
        x0 = torch.cat([x0, x0.new_zeros((big - x0.shape[0],)
                                         + tuple(x0.shape[1:]))])
    out = x0.new_empty((n * big,) + tuple(x0.shape[1:]))
    _ALL_GATHER(out, x0, group=split.group)
    if min(split.sizes) < big:
        out = torch.cat([out[r * big:r * big + s]
                         for r, s in enumerate(split.sizes)])
    return _from_front(out, split.dim)


def _rs(x: torch.Tensor, split: Split) -> torch.Tensor:
    """Sum a whole tensor over the ranks and keep this rank's part."""
    n, big = len(split.sizes), max(split.sizes)
    x0 = _to_front(x, split.dim)
    if min(split.sizes) < big:
        padded = x0.new_zeros((n * big,) + tuple(x0.shape[1:]))
        off = 0
        for r, s in enumerate(split.sizes):
            padded[r * big:r * big + s] = x0[off:off + s]
            off += s
        x0 = padded
    out = x0.new_empty((big,) + tuple(x0.shape[1:]))
    _REDUCE_SCATTER(out, x0, group=split.group)
    return _from_front(out[:split.sizes[split.index]], split.dim)


def _apply(op: str, x: torch.Tensor, group, split: Optional[Split]):
    if op == 'id':
        return x
    if op == 'ar':
        return _ar(x, group)
    if op == 'ag':
        return _ag(x, split)
    if op == 'rs':
        return _rs(x, split)
    if op == 'slice':
        return split.local(x).contiguous()
    raise ValueError(op)


class _Comm(torch.autograd.Function):
    """A collective `fwd` whose backward is the collective `bwd`."""

    @staticmethod
    def forward(ctx, x, fwd, bwd, group, split):
        ctx.bwd, ctx.group, ctx.split = bwd, group, split
        return _apply(fwd, x, group, split)

    @staticmethod
    def backward(ctx, g):
        return _apply(ctx.bwd, g, ctx.group, ctx.split), None, None, None, \
            None


# The 'data' axis: exact adjoints
def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over the group; backward all-reduces the gradient."""
    return _Comm.apply(x, 'ar', 'ar', group, None)


def all_gather(x: torch.Tensor, split: Split) -> torch.Tensor:
    """Every rank's part concatenated along split.dim; backward
    reduce-scatters."""
    return _Comm.apply(x, 'ag', 'rs', split.group, split)


def reduce_scatter(x: torch.Tensor, split: Split) -> torch.Tensor:
    """This rank's part of the sum of a whole tensor over the ranks;
    backward all-gathers."""
    return _Comm.apply(x, 'rs', 'ag', split.group, split)


# The 'model' axis: Megatron's convention
def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    return _Comm.apply(x, 'id', 'ar', group, None)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    return _Comm.apply(x, 'ar', 'id', group, None)


def scatter_to(x: torch.Tensor, split: Split) -> torch.Tensor:
    return _Comm.apply(x, 'slice', 'ag', split.group, split)


def gather_from(x: torch.Tensor, split: Split) -> torch.Tensor:
    return _Comm.apply(x, 'ag', 'slice', split.group, split)


def gather_plain(x: torch.Tensor, split: Split) -> torch.Tensor:
    """all_gather without autograd (state, outputs)."""
    with torch.no_grad():
        return _ag(x, split)


def reduce_scatter_plain(x: torch.Tensor, split: Split) -> torch.Tensor:
    """reduce_scatter without autograd (tables, data)."""
    with torch.no_grad():
        return _rs(x, split)


def all_reduce_plain(x: torch.Tensor, group) -> torch.Tensor:
    """all_reduce without autograd, out of place."""
    with torch.no_grad():
        return _ar(x, group)


# ---------------------------------------------------------- rank 0 I/O
def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_rank0() -> bool:
    return rank() == 0


@contextlib.contextmanager
def rank0_stdout():
    """Silence standard output on every rank but 0 (SPMD runs print once)."""
    if is_rank0():
        yield
        return
    with open(os.devnull, 'w') as sink, contextlib.redirect_stdout(sink):
        yield


def broadcast_from_rank0(x, mesh):
    """Rank 0's value of x on every rank of the mesh's group (an ndarray
    or a tensor, returned in kind; a tensor is overwritten in place)."""
    device = torch.device('cuda', torch.cuda.current_device()) \
        if mesh.device_type == 'cuda' else torch.device('cpu')
    if isinstance(x, torch.Tensor):
        t = x if x.device == device else x.to(device)
        t = t.contiguous()
        dist.broadcast(t, src=0)
        return t.to(x.device) if t.device != x.device else t
    arr = np.ascontiguousarray(x)
    t = torch.as_tensor(arr).to(device)
    dist.broadcast(t, src=0)
    return t.cpu().numpy().astype(arr.dtype, copy=False)


# ------------------------------------------------------- local launcher
def _spawn_worker(rank_: int, fn: Callable, world: int, backend: str,
                  store_path: str, mesh_shape, args, out_dir: str) -> None:
    torch.set_num_threads(1)
    if backend == 'nccl':
        torch.cuda.set_device(rank_)
    dist.init_process_group(backend, store=dist.FileStore(store_path, world),
                            rank=rank_, world_size=world)
    try:
        mesh = create_mesh(mesh_shape, (DATA, MODEL)[:len(mesh_shape)],
                           device_type='cuda' if backend == 'nccl' else 'cpu')
        result = fn(mesh, *args)
        torch.save(result, os.path.join(out_dir, f'rank{rank_}.pt'))
    finally:
        dist.destroy_process_group()


def spawn_local(fn: Callable, world_size: int, backend: str = 'gloo',
                mesh_shape: Optional[Sequence[int]] = None,
                args: tuple = ()) -> list:
    """Run fn(mesh, *args) on `world_size` local processes (the spawn
    start method, a FileStore rendezvous in a temporary directory, no TCP
    port) and return each rank's result, in rank order.

    fn must be importable by name (a module-level function). mesh_shape
    defaults to (world_size,): a 1-D mesh is ('data',), a 2-D one
    ('data', 'model'). backend 'nccl' puts rank r on CUDA device r. A rank
    that raises makes this call raise."""
    import torch.multiprocessing as mp
    shape = (world_size,) if mesh_shape is None else tuple(mesh_shape)
    if len(shape) not in (1, 2):
        raise ValueError(f'mesh_shape {shape}: one or two dims')
    tmp = tempfile.mkdtemp(prefix='jamie_spawn_')
    try:
        mp.start_processes(
            _spawn_worker, nprocs=world_size, start_method='spawn',
            args=(fn, world_size, backend, os.path.join(tmp, 'store'), shape,
                  tuple(args), tmp))
        return [torch.load(os.path.join(tmp, f'rank{r}.pt'),
                           weights_only=False) for r in range(world_size)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def modules_loaded(*names: str) -> List[str]:
    """The loaded modules among `names` and their submodules."""
    return sorted(m for m in sys.modules
                  if any(m == n or m.startswith(n + '.') for n in names))
