"""Host-resident training set, streamed to the device batch by batch
(``Config.stream_data``: datasets larger than device memory).

Port of the stream path of ``ubpl_tpu/train/base_trainer.py``:
``_place_train`` (``:132-141``: the training arrays stay on the host),
``fetch_batch`` (``:423-433``: a step takes an already-transferred batch)
and ``_stream_batches`` (``:451-465``: batch i+1's host-to-device copy is
issued before step i, so it can overlap step i's compute).

On a CUDA trainer the host arrays are pinned, each batch is gathered on the
host into one of two pinned staging buffers, and its copy is issued with
``non_blocking=True`` on a side stream.  The consuming step's stream waits
on the copy's event (on the device, not the host), and the batch's device
tensors are marked as used by that stream (``record_stream``), so the
caching allocator does not hand their memory to the next copy early.  A
staging buffer is written again only after the copy that last read it has
finished (its event).  On the CPU (tests) a batch is the host gather.
"""
from typing import NamedTuple

import numpy as np
import torch


class HostDataset(NamedTuple):
    images: torch.Tensor     # [N, R, R, 3] uint8 (BGR), host memory
    kps: torch.Tensor        # [N, K, 3] float32
    islabeled: torch.Tensor  # [N] int32


def host_dataset(images, kps, islabeled, device):
    """The training arrays as host tensors; pinned when they feed a CUDA
    device (an asynchronous copy needs page-locked memory)."""
    arrays = HostDataset(torch.as_tensor(np.asarray(images)),
                         torch.as_tensor(np.asarray(kps, np.float32)),
                         torch.as_tensor(np.asarray(islabeled, np.int32)))
    if device.type == "cuda":
        arrays = HostDataset(*(a.pin_memory() for a in arrays))
    return arrays


class StreamedBatch:
    """One batch on its way to the device: its tensors and, on CUDA, the
    event recorded after their copy."""

    def __init__(self, tensors, ready=None):
        self.tensors = tuple(tensors)
        self.ready = ready

    def take(self):
        """(images, kps, islabeled) for use on the current stream."""
        if self.ready is not None:
            stream = torch.cuda.current_stream(self.tensors[0].device)
            stream.wait_event(self.ready)
            for t in self.tensors:
                t.record_stream(stream)
        return self.tensors


class _Slot:
    """A pinned staging buffer per array and the event of the last copy
    that read it."""

    def __init__(self, host, rows):
        self.rows = rows
        self.bufs = [torch.empty((rows,) + tuple(a.shape[1:]), dtype=a.dtype,
                                 pin_memory=True) for a in host]
        self.done = None


class BatchStreamer:
    """Gathers training batches from a ``HostDataset`` and moves them to
    ``device`` one batch ahead of the step that consumes them."""

    def __init__(self, host: HostDataset, device):
        self.host = host
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        if self.cuda:
            if not all(a.is_pinned() for a in host):
                raise ValueError("stream_data on CUDA needs pinned host "
                                 "arrays (host_dataset pins them)")
            self.stream = torch.cuda.Stream(device=self.device)
            self._slots = [None, None]
            self._n_put = 0

    def put(self, idxs) -> StreamedBatch:
        """Gather rows ``idxs`` on the host and issue their copy."""
        i = torch.as_tensor(np.asarray(idxs, np.int64))
        if not self.cuda:
            return StreamedBatch(a.index_select(0, i) for a in self.host)
        k = self._n_put % 2
        self._n_put += 1
        slot = self._slots[k]
        if slot is not None and slot.done is not None:
            slot.done.synchronize()         # its last copy has read it
        if slot is None or slot.rows < len(i):
            slot = self._slots[k] = _Slot(self.host, len(i))
        staged = [torch.index_select(a, 0, i, out=buf[:len(i)])
                  for a, buf in zip(self.host, slot.bufs)]
        with torch.cuda.stream(self.stream):
            tensors = [s.to(self.device, non_blocking=True) for s in staged]
            slot.done = torch.cuda.Event()
            slot.done.record(self.stream)
        return StreamedBatch(tensors, slot.done)

    def batches(self, batch_iter):
        """Yield a ``StreamedBatch`` per index batch, each issued before the
        previous one is handed out."""
        pending = None
        for idxs in batch_iter:
            nxt = self.put(idxs)
            if pending is not None:
                yield pending
            pending = nxt
        if pending is not None:
            yield pending
