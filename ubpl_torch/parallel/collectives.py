"""The explicit reductions and exchanges of training over several
processes.

Under GSPMD the JAX package computes every batch reduction over the global
batch without a word in the code (``ubpl_tpu/parallel/mesh.py``: "No
explicit psum/all_reduce calls are needed"), and its losses read both
branches of a ``model``-sharded stack as if they were local.  The port runs
one process per card, so each of those reductions and exchanges is one call
here.  Only ``all_reduce``, ``all_gather``, ``broadcast`` and ``barrier``
are used: the four that gloo implements on CUDA tensors as well as NCCL
does, so the same code runs under NCCL across cards, under gloo on the CPU
and under gloo with several ranks on one card.

A rank's collectives run over one of three groups: its ``BatchGroup`` (the
ranks that split its batches: losses, gradients, BatchNorm statistics), its
``BranchGroup`` (the ranks that split its branches: the teachers' outputs,
the students' features, MLD's norms, checkpoints) or the world (barriers
and the preemption flag).  Every function takes the group (or None) and is
a no-op without one, so the single-process path runs exactly as before.
"""
import torch
import torch.distributed as dist

from .mesh import batch_shard, local_branches

# {(world, ranks): process group} of the groups made so far in this world
_PROCESS_GROUPS = {}


def _process_groups(mesh):
    """Make every batch group and every branch group of ``mesh`` once per
    world, in the same order on every rank (``new_group`` is a collective
    of the whole world: a rank that skips one deadlocks the others).  A
    group of the whole world runs on the default group (None); a group of
    one process needs none."""
    world = id(dist.group.WORLD)
    if (world, mesh) in _PROCESS_GROUPS:
        return
    spans = sorted({tuple(f(r)) for f in (mesh.batch_group, mesh.branch_group)
                    for r in range(mesh.size)} | {tuple(range(mesh.size))})
    for ranks in spans:
        if len(ranks) > 1 and (world, ranks) not in _PROCESS_GROUPS:
            _PROCESS_GROUPS[world, ranks] = (
                None if len(ranks) == mesh.size
                else dist.new_group(list(ranks)))
    _PROCESS_GROUPS[world, mesh] = True


class Group:
    """Some ranks of the world and the process group of their collectives
    (``pg``; None: the default group): their global ranks in ascending
    order (the process group's rank order), this process's rank and its
    index among them, and the device its collectives run on.  Shared, not
    copied, when a module that holds it is deep-copied (an EMA teacher)."""

    def __init__(self, mesh, ranks, device):
        if mesh.size != dist.get_world_size():
            raise ValueError(f"mesh {mesh.shape} has {mesh.size} devices, "
                             f"the world {dist.get_world_size()} processes")
        _process_groups(mesh)
        self.mesh = mesh
        self.ranks = sorted(ranks)
        self.rank = dist.get_rank()
        self.index = self.ranks.index(self.rank)
        self.size = len(self.ranks)
        self.pg = _PROCESS_GROUPS[id(dist.group.WORLD), tuple(self.ranks)]
        self.device = torch.device(device)

    def __deepcopy__(self, memo):
        return self


class BatchGroup(Group):
    """The processes among which each batch is split (the ranks with this
    rank's ``model`` index): also this process's shard index and the
    members in shard order."""

    def __init__(self, mesh, device):
        super().__init__(mesh, mesh.batch_group(dist.get_rank()), device)
        self.shard = batch_shard(mesh, self.rank)
        #: the members' indices in shard order: where each gathered piece
        #: belongs
        self.order = sorted(range(self.size),
                            key=lambda i: batch_shard(mesh, self.ranks[i]))


class BranchGroup(Group):
    """The processes among which the ``n_branch`` stacked branches are
    split (the ranks with this rank's batch coordinates, in ``model``
    order): ``local``, the branches this rank holds, and the exchanges that
    the losses, MLD, validation and checkpoints need between them."""

    def __init__(self, mesh, device, n_branch):
        super().__init__(mesh, mesh.branch_group(dist.get_rank()), device)
        self.n_branch = n_branch
        self.local = local_branches(mesh, self.rank, n_branch)

    def gather(self, x):
        """[size, *x.shape]: every member's ``x`` in ``model`` order (no
        gradient)."""
        pieces = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(pieces, x.detach().contiguous(), group=self.pg)
        return torch.stack(pieces)

    def gather_branches(self, x):
        """[n_branch, ...] from this rank's ``x`` [len(local), ...]: every
        branch's slice in branch order (no gradient)."""
        return self.gather(x).flatten(0, 1)

    def gather_branches_grad(self, x):
        """``gather_branches`` through which the gradient flows back: the
        gradient of the stacked result is summed over the group and each
        rank keeps its own branches' slice.  Every rank's loss adds up to
        the whole loss only where each rank weights a term that all of
        them compute by ``1 / size`` (see ``mt_ubpl.loss_groups``)."""
        return _GatherBranches.apply(x, self)

    def sum_over_branches(self, x):
        """``x`` summed over the group (a new tensor, no gradient)."""
        x = x.detach().clone()
        dist.all_reduce(x, group=self.pg)
        return x

    def gather_many(self, tensors):
        """``gather`` of several tensors of any dtypes and shapes in one
        collective: their bytes packed into one buffer on the group's
        device.  Returns [size, *t.shape] per tensor, on that device."""
        flat = [t.detach().to(self.device).contiguous().reshape(-1)
                .view(torch.uint8) for t in tensors]
        rows = self.gather(torch.cat(flat))
        out, lo = [], 0
        for t, b in zip(tensors, flat):
            piece = rows[:, lo:lo + b.numel()].contiguous()
            out.append(piece.view(t.dtype).reshape((self.size,) + t.shape))
            lo += b.numel()
        return out


class _GatherBranches(torch.autograd.Function):
    """all_gather forward, all_reduce backward (gloo has no
    ``reduce_scatter`` on CUDA tensors)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.n = group, x.shape[0]
        return group.gather_branches(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group.pg)
        lo = ctx.group.index * ctx.n
        return grad[lo:lo + ctx.n], None


def _needs_world(mesh):
    if not dist.is_initialized():
        raise RuntimeError(
            f"a mesh of {mesh.size} devices runs one process per device: "
            "start it through ubpl_torch.parallel.launch or torchrun")


def batch_group(mesh, device):
    """The ``BatchGroup`` of this process on ``mesh``, or None where the
    batch is not split (no mesh, or one shard per batch)."""
    if mesh is None or len(mesh.batch_group(0)) == 1:
        return None
    _needs_world(mesh)
    return BatchGroup(mesh, device)


def branch_group(mesh, device, n_branch):
    """The ``BranchGroup`` of this process for an ``n_branch`` axis on
    ``mesh``, or None where the branches are not split (no mesh, a
    ``model`` axis of 1, or a regime without a branch axis: ``n_branch``
    1).  Raises the JAX package's ``ValueError`` where ``model`` does not
    divide ``n_branch``."""
    if mesh is None or n_branch <= 1:
        return None
    if len(local_branches(mesh, 0, n_branch)) == n_branch:
        return None
    _needs_world(mesh)
    return BranchGroup(mesh, device, n_branch)


def world_group(mesh, device):
    """The whole world of ``mesh`` as a ``Group`` (barriers, the preemption
    flag), or None on one process."""
    if mesh is None or mesh.size == 1:
        return None
    _needs_world(mesh)
    return Group(mesh, range(mesh.size), device)


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
        dist.all_reduce(x, group=group.pg)
    return x


def all_reduce_packed(tensors, group, dtype=None):
    """Sum several tensors over the group in one collective: flattened
    into one buffer of ``dtype`` (default: the first's), reduced, and
    returned in their own shapes and dtypes."""
    if group is None:
        return list(tensors)
    dtype = dtype or tensors[0].dtype
    flat = torch.cat([t.detach().reshape(-1).to(dtype) for t in tensors])
    dist.all_reduce(flat, group=group.pg)
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
    dist.all_reduce(buf, group=group.pg)
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
    return _flat_in_place(
        grads, lambda flat: dist.all_reduce(flat, group=group.pg))


def all_gather_rows(x, group):
    """Concatenate every shard's rows (dim 0) in shard order.  The row
    counts may differ: each piece is padded to the largest for the
    collective and cut back after it."""
    if group is None:
        return x
    counts = torch.zeros(group.size, dtype=torch.int64, device=x.device)
    counts[group.shard] = x.shape[0]
    dist.all_reduce(counts, group=group.pg)
    counts = counts.tolist()
    top = max(counts)
    padded = x.new_zeros((top,) + tuple(x.shape[1:]))
    padded[:x.shape[0]] = x
    pieces = [torch.empty_like(padded) for _ in range(group.size)]
    dist.all_gather(pieces, padded.contiguous(), group=group.pg)
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
    dist.all_reduce(flat, group=group.pg)
    out, lo = [], 0
    for t, b in zip(tensors, as_bytes):
        piece = flat[:, lo:lo + b.shape[1]].contiguous()
        out.append(piece.view(t.dtype).reshape(t.shape))
        lo += b.shape[1]
    return out


def broadcast_(tensors, group, src=0):
    """Overwrite each tensor in place with the group's ``src``-th member's
    (``src`` is an index into the group, not a global rank; one broadcast
    per dtype)."""
    if group is None:
        return tensors
    return _flat_in_place(tensors, lambda flat: dist.broadcast(
        flat, group.ranks[src], group=group.pg))


def any_true(flag, group):
    """True on every rank when ``flag`` is true on any (a host read)."""
    if group is None:
        return bool(flag)
    t = torch.tensor([1 if flag else 0], dtype=torch.int32,
                     device=group.device)
    dist.all_reduce(t, group=group.pg)
    return bool(t.item())


def barrier(group):
    if group is not None:
        dist.barrier(group=group.pg)
