"""Runner of the pose training cells that span cards: the program's
MT_UBPL trainer on every rank of a mesh, one process per card (NCCL; gloo
ranks on the CPU), each stepped through ``run_train_steps``, one call per
batch, as the program's multi-rank runs drive it
(``parallel.launch.launch``).

Traffic parameters: those of ``train_pose``, the batch being the global
one, and ``mesh_shape`` and ``mesh_axes`` (``parallel.mesh.make_mesh``).

Each rank builds the trainer on its card with the mesh and is handed the
inputs that ``train_pose`` makes from the seed: its shard of the dataset,
its branches' weights, the batch order and the seed of the augmentation
generator (every rank draws the whole batch's draws and keeps its rows).
The check steps run on every rank.  Their readings come back to this
process, which holds each rank's (its branches', with the other branches'
from the ranks that hold the same rows) against the one-card reference
over the whole batch, the worst rank deciding.

This process computes nothing of the program and leaves the cards to the
ranks: it sends each phase to them and waits for their replies.  Rank 0
times the window, with a synchronise at each end.  After each step it
looks at its clock and starts a gloo broadcast of whether to go on; every
rank reads that answer ``STOP_LAG`` steps later, so that all take the same
steps and no rank's host waits for rank 0's at each step.  A ``--trace 1`` run profiles the stretch on every rank; the
per-layer metrics read rank 0's trace, its busy time the mean of the
ranks'.
"""
import collections
import contextlib
import queue
import threading
import time

import numpy as np
import torch

from .. import flops
from .. import trace as T
from .. import weights as W
from ..harness import Window, seeds
from . import train_pose
from .training import Readings, batch_order

#: seconds a rank waits for its next order, and the launch for each
#: collective, before they fail
ORDER_TIMEOUT = 1200
#: steps between rank 0's look at its clock and the ranks' reading of it
STOP_LAG = 2


def _branch_tag(name, branches):
    """A leaf's rank-local name ("s0.x", "t0.x") with the global index of
    the rank's branch."""
    tag, rest = name.split(".", 1)
    return f"{tag[0]}{branches[int(tag[1:])]}.{rest}"


class RankProgram(train_pose.Program):
    """The program's side on one rank: ``train_pose``'s set-up and check
    steps with the mesh, and the phases that the parent orders."""

    def __init__(self, cell, seed, ctx):
        import torch.distributed as dist
        self.rank = ctx.rank
        super().__init__(cell, seed, ctx.device, ctx.mesh)
        self.control = dist.new_group(backend="gloo")
        self._sync()

    def _sync(self):
        if self.trainer.device.type == "cuda":
            torch.cuda.synchronize(self.trainer.device)

    def window(self, seconds):
        import torch.distributed as dist
        self._sync()
        dist.barrier(group=self.control)
        t0 = time.perf_counter()
        steps, go, sent = 0, True, collections.deque()
        while go:
            self._step(next(self.batches))
            steps += 1
            flag = torch.tensor([self.rank != 0 or
                                 time.perf_counter() - t0 < seconds],
                                dtype=torch.int32)
            sent.append((flag, dist.broadcast(flag, 0, group=self.control,
                                              async_op=True)))
            if len(sent) > STOP_LAG:
                flag, work = sent.popleft()
                work.wait()
                go = bool(flag.item())
        for _, work in sent:
            work.wait()
        self._sync()
        dt = time.perf_counter() - t0
        return Window(steps, dt, steps * self.flops_per_step,
                      {"train_images_per_s": steps * self.bs / dt})

    def profile(self, _):
        return T.profile(self.stretch, self.stretch_units)

    def memory(self, _):
        d = self.trainer.device
        return torch.cuda.max_memory_allocated(d) if d.type == "cuda" else 0

    def release(self, _):
        """This rank's readings (leaves under their global branch names,
        the targets as numpy arrays), its branches and its rows."""
        tr, r = self.trainer, self.readings
        branches = list(tr.branch_ids(tr.n_models))
        rows = tr.local_rows(self.bs)
        out = Readings(
            r.losses, {_branch_tag(n, branches): v
                       for n, v in r.first_grads.items()},
            {_branch_tag(n, branches): v for n, v in r.changes.items()},
            r.counts, r.terms,
            [(hm.cpu().numpy(), kps.cpu().numpy()) for hm, kps in r.maps])
        del self.trainer, tr
        return out, tuple(branches), rows.start


def _rank(ctx, cell, seed, fault, orders, replies):
    """One rank: set-up, then each order of the parent until
    ``release``."""
    from .. import calibrate
    with (calibrate.FAULTS[fault][1](RankProgram) if fault
          else contextlib.nullcontext()):
        prog = RankProgram(cell, seed, ctx)
        replies.put((ctx.rank, None))
        while True:
            order, arg = orders[ctx.rank].get(timeout=ORDER_TIMEOUT)
            replies.put((ctx.rank, getattr(prog, order)(arg)))
            if order == "release":
                return None


class Program:
    """The parent's side: the ranks' launch and the phases of a run."""
    #: a fault of ``calibrate.FAULTS`` that every rank plants
    fault = None

    def __init__(self, cell, seed, device):
        from ubpl_torch.parallel.launch import launch
        from ubpl_torch.parallel.mesh import make_mesh
        t = cell.traffic
        self.cell, self.seed, self.device = cell, seed, device
        self.mesh = make_mesh(tuple(t["mesh_shape"]), tuple(t["mesh_axes"]))
        self.bs = t["batch_unlabeled"] + t["batch_labeled"]
        self.stretch_units = t["trace_steps"]
        mp = torch.multiprocessing.get_context("spawn")
        self._orders = [mp.Queue() for _ in range(self.mesh.size)]
        self._replies = mp.Queue()
        self._failed = None

        def run():
            try:
                launch(_rank, self.mesh, device.type, timeout=ORDER_TIMEOUT,
                       args=(cell, seed, self.fault, self._orders,
                             self._replies))
            except BaseException as e:      # re-raised by _gather
                self._failed = e

        self._launch = threading.Thread(target=run, daemon=True)
        self._launch.start()
        self._gather()

    def _gather(self):
        """One reply from every rank, in rank order."""
        got = {}
        while len(got) < self.mesh.size:
            try:
                rank, reply = self._replies.get(timeout=1.0)
            except queue.Empty:
                if not self._launch.is_alive():
                    raise RuntimeError("the ranks stopped") from self._failed
                continue
            got[rank] = reply
        return [got[r] for r in range(self.mesh.size)]

    def _ask(self, order, arg=None):
        for q in self._orders:
            q.put((order, arg))
        return self._gather()

    def window(self, seconds):
        return self._ask("window", seconds)[0]

    def profile(self, units):
        traces = self._ask("profile")
        summary = traces[0]
        summary.busy_s = sum(s.busy_s for s in traces) / len(traces)
        return summary

    def memory_peak_bytes(self):
        return max(self._ask("memory"))

    def release(self):
        """The ranks' readings, once they have ended, and the inputs of
        the check steps made again from the seed."""
        got = self._ask("release")
        self._launch.join()
        if self._failed is not None:
            raise RuntimeError("the ranks stopped") from self._failed
        c, t = self.cell.config, self.cell.traffic
        s_data, s_weights, s_aug, s_order, _ = seeds(self.seed, 5)
        images, kps, islabeled, n_lab = train_pose.make_dataset(
            self.cell, s_data, self.device)
        order = batch_order(images.shape[0], n_lab, t["batch_unlabeled"],
                            t["batch_labeled"], s_order)
        rows = torch.as_tensor(np.concatenate(
            [next(order) for _ in range(t["check_steps"])]),
            device=self.device)
        n_branches = len({b for _, branches, _ in got for b in branches})
        states = W.make_states(c["model"], c["kps"], n_branches, s_weights,
                               self.device)
        means = torch.tensor(c["means"], dtype=torch.float32,
                             device=self.device)
        kept = train_pose.Kept(self.cell, self.device, states, s_aug,
                               images[rows].clone(), kps[rows].clone(),
                               islabeled[rows].clone(), means,
                               whole_readings(got, self.device))
        shards = len({start for _, _, start in got})
        kept.kernel_bytes = {"heatmap_synth": flops.heatmap_bytes(
            self.bs // shards, c["kps"], c["out_res"])}
        return kept


def whole_readings(got, device):
    """Per rank, readings over the whole batch and every branch: its own
    losses, counts and terms; every branch's leaves from the ranks that
    hold its rows; the targets of the ranks that hold its branches, their
    rows in order."""
    out = []
    for readings, branches, start in got:
        same_rows = [r for r, _, s in got if s == start]
        same_branches = sorted((s, r) for r, b, s in got if b == branches)
        maps = [tuple(torch.as_tensor(np.concatenate(
            [r.maps[j][i] for _, r in same_branches]), device=device)
            for i in range(2)) for j in range(len(readings.maps))]
        out.append(Readings(
            readings.losses,
            {k: v for r in same_rows for k, v in r.first_grads.items()},
            {k: v for r in same_rows for k, v in r.changes.items()},
            readings.counts, readings.terms, maps))
    return out
