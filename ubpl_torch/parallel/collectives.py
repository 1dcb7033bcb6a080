"""The explicit reductions of data-parallel training.

Under GSPMD the JAX package computes every batch reduction over the global
batch without a word in the code (``ubpl_tpu/parallel/mesh.py``: "No
explicit psum/all_reduce calls are needed").  The port runs one process
per card, so each of those reductions is one call here.  Only
``all_reduce``, ``all_gather``, ``broadcast`` and ``barrier`` are used: the
four that gloo implements on CUDA tensors as well as NCCL does, so the same
code runs under NCCL across cards, under gloo on the CPU and under gloo
with several ranks on one card.  Every function takes the ``BatchGroup``
(or None) and is a no-op without one, so the single-process path runs
exactly as before.
"""
import torch
import torch.distributed as dist

from .mesh import batch_shard


class BatchGroup:
    """The processes among which each batch is split: this process's
    shard index, the group's size, and the device its collectives run on.

    The batch group is the whole world: ``mesh.make_mesh`` refuses a
    non-batch axis of more than one device.  It is shared, not copied, when
    a module that holds it is deep-copied (an EMA teacher)."""

    def __init__(self, mesh, device):
        rank, world = dist.get_rank(), dist.get_world_size()
        if mesh.size != world or len(mesh.batch_group(rank)) != world:
            raise ValueError(f"mesh {mesh.shape} does not split the batch "
                             f"over the {world} processes of the world")
        self.mesh = mesh
        self.rank = rank
        self.size = world
        self.shard = batch_shard(mesh, rank)
        #: the ranks in shard order: where each gathered piece belongs
        self.order = sorted(range(world), key=lambda r: batch_shard(mesh, r))
        self.device = torch.device(device)

    def __deepcopy__(self, memo):
        return self


def batch_group(mesh, device):
    """The ``BatchGroup`` of this process on ``mesh``, or None where the
    batch is not split (no mesh, or one shard)."""
    if mesh is None or mesh.size == 1:
        return None
    if not dist.is_initialized():
        raise RuntimeError(
            f"a mesh of {mesh.size} devices runs one process per device: "
            "start it through ubpl_torch.parallel.launch or torchrun")
    return BatchGroup(mesh, device)


def size(group):
    """Number of shards (1 without a group)."""
    return 1 if group is None else group.size


def shard(group):
    """This process's shard index (0 without a group)."""
    return 0 if group is None else group.shard


def is_writer():
    """True on the process that writes files and logs: rank 0, or the only
    process."""
    return not dist.is_initialized() or dist.get_rank() == 0


def all_reduce_sum(x, group):
    """Sum ``x`` over the group in place; returns it."""
    if group is not None:
        dist.all_reduce(x)
    return x


def all_reduce_packed(tensors, group, dtype=None):
    """Sum several tensors over the group in one collective: flattened
    into one buffer of ``dtype`` (default: the first's), reduced, and
    returned in their own shapes and dtypes."""
    if group is None:
        return list(tensors)
    dtype = dtype or tensors[0].dtype
    flat = torch.cat([t.detach().reshape(-1).to(dtype) for t in tensors])
    dist.all_reduce(flat)
    out = []
    for t, piece in zip(tensors, flat.split([t.numel() for t in tensors])):
        out.append(piece.reshape(t.shape).to(t.dtype))
    return out


def all_gather_stacked(x, group):
    """[shards, *x.shape]: every shard's ``x`` in shard order, as one
    all-reduce of a buffer in which each rank fills its own row (each row
    has one writer, so the sum is that writer's value)."""
    if group is None:
        return x[None]
    buf = x.new_zeros((group.size,) + tuple(x.shape))
    buf[group.shard] = x
    dist.all_reduce(buf)
    return buf


def _flat_in_place(tensors, collective):
    """Run ``collective`` on one flat buffer per dtype of ``tensors`` and
    copy the result back into each (any memory layout).  None entries are
    skipped."""
    by_dtype = {}
    for t in tensors:
        if t is not None:
            by_dtype.setdefault(t.dtype, []).append(t)
    for same in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in same])
        collective(flat)
        for t, piece in zip(same, flat.split([t.numel() for t in same])):
            t.copy_(piece.view(t.shape))
    return tensors


def all_reduce_grads(grads, group):
    """Sum a list of gradient tensors over the group in place: one flat
    buffer per dtype, one all-reduce each.  None entries are skipped (the
    same on every rank: the ranks run one graph)."""
    if group is None:
        return grads
    return _flat_in_place(grads, dist.all_reduce)


def all_gather_rows(x, group):
    """Concatenate every shard's rows (dim 0) in shard order.  The row
    counts may differ: each piece is padded to the largest for the
    collective and cut back after it."""
    if group is None:
        return x
    counts = torch.zeros(group.size, dtype=torch.int64, device=x.device)
    counts[group.shard] = x.shape[0]
    dist.all_reduce(counts)
    counts = counts.tolist()
    top = max(counts)
    padded = x.new_zeros((top,) + tuple(x.shape[1:]))
    padded[:x.shape[0]] = x
    pieces = [torch.empty_like(padded) for _ in range(group.size)]
    dist.all_gather(pieces, padded.contiguous())
    by_shard = [pieces[r] for r in group.order]
    return torch.cat([p[:n] for p, n in zip(by_shard, counts)])


def sum_rows_bytes(tensors, group):
    """Sum tensors of equal row count over the group as raw bytes, in one
    collective.  Exact where each row has one contributing rank and zeros
    elsewhere (the masked gathers of ``BaseTrainer.gather_rows``), whatever
    the dtype."""
    if group is None:
        return list(tensors)
    n = tensors[0].shape[0]
    as_bytes = [t.contiguous().view(torch.uint8).reshape(n, -1)
                for t in tensors]
    flat = torch.cat(as_bytes, dim=1)
    dist.all_reduce(flat)
    out, lo = [], 0
    for t, b in zip(tensors, as_bytes):
        piece = flat[:, lo:lo + b.shape[1]].contiguous()
        out.append(piece.view(t.dtype).reshape(t.shape))
        lo += b.shape[1]
    return out


def broadcast_(tensors, group, src=0):
    """Overwrite each tensor in place with rank ``src``'s (one broadcast
    per dtype)."""
    if group is None:
        return tensors
    return _flat_in_place(tensors, lambda flat: dist.broadcast(flat, src))


def any_true(flag, group):
    """True on every rank when ``flag`` is true on any (a host read)."""
    if group is None:
        return bool(flag)
    t = torch.tensor([1 if flag else 0], dtype=torch.int32,
                     device=group.device)
    dist.all_reduce(t)
    return bool(t.item())


def barrier(group):
    if group is not None:
        dist.barrier()
