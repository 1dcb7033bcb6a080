"""``stream_data``: the training set stays on the host and each batch is
moved to the device one step ahead (``ubpl_torch/train/streaming.py``).

On the CPU a streamed batch is the host gather, so a streamed trainer must
take exactly the resident trainer's steps (bit-equal).  The CUDA mechanics
(pinned staging buffers, the side stream, the event and ``record_stream``)
run only on the card: the test that needs one is marked ``cuda`` and skips
here; ``chip_smoke.py`` drives them at full size.  Sizes: HG1, K=5,
64 -> 16, bs 2, float32, torch single-threaded.
"""
import os
import tempfile

import numpy as np
import pytest
import torch

from ubpl_torch.config import Config
from ubpl_torch.data.sampler import supervised_epoch_batches
from ubpl_torch.train import streaming as ST
from ubpl_torch.train.dualpose_ubpl import DualPoseUBPLTrainer
from ubpl_torch.train.mt_ubpl import MTUBPLTrainer
from ubpl_torch.train.supervised import SupervisedTrainer

K = 5
KW = dict(model="HG1", synthetic_data=True, synthetic_kps=K, inp_res=64,
          out_res=16, train_count=8, valid_count=4, label_ratio=0.5,
          train_bs=2, train_bs_labeled=1, infer_bs=4,
          compute_dtype="float32", seed=3)
SCHED = (3.0, 0.7, 0.8, 0.5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several pytest workers share the host: compute single-threaded."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _host(n=10, seed=0):
    rng = np.random.default_rng(seed)
    return ST.host_dataset(rng.integers(0, 256, (n, 8, 8, 3), dtype=np.uint8),
                           rng.uniform(0, 8, (n, K, 3)),
                           rng.integers(0, 2, (n,)), torch.device("cpu"))


def test_host_dataset_layout():
    """uint8 images, float32 kps, int32 islabeled, on the host, not pinned
    for a CPU trainer."""
    h = _host()
    assert (h.images.dtype, h.kps.dtype, h.islabeled.dtype) == (
        torch.uint8, torch.float32, torch.int32)
    assert all(a.device.type == "cpu" and not a.is_pinned() for a in h)


def test_streamer_gathers_rows():
    """Each streamed batch holds exactly the requested rows, ragged sizes
    included, in order."""
    h = _host()
    batches = [[3, 1], [0, 9, 4], [7]]
    got = list(ST.BatchStreamer(h, "cpu").batches(batches))
    assert len(got) == 3
    for idxs, b in zip(batches, got):
        imgs, kps, isl = b.take()
        i = torch.as_tensor(idxs)
        assert torch.equal(imgs, h.images[i]) and torch.equal(kps, h.kps[i])
        assert torch.equal(isl, h.islabeled[i])


def test_streamer_issues_one_batch_ahead(monkeypatch):
    """Batch i + 1 is put (its copy issued) before batch i is handed out."""
    events = []
    streamer = ST.BatchStreamer(_host(), "cpu")
    real_put = streamer.put

    def put(idxs):
        events.append(("put", idxs[0]))
        return real_put(idxs)

    monkeypatch.setattr(streamer, "put", put)
    for b in streamer.batches([[0], [1], [2]]):
        events.append(("take", int(b.tensors[2].numel())))
    assert [e[0] for e in events] == ["put", "put", "take", "put", "take",
                                      "take"]


def _pair(cls, **kw):
    cfg = dict(KW, **kw)
    return (cls(Config(**cfg), device="cpu"),
            cls(Config(**cfg, stream_data=True), device="cpu"))


def _same_steps(resident, streamed, batches, sched):
    """Both trainers take `batches`; metrics and every network's state
    must be bit-equal."""
    m_res = resident.run_train_steps(batches, *sched)
    m_str = streamed.run_train_steps(batches, *sched)
    assert len(m_res) == len(m_str) == len(batches)
    for a, b in zip(m_res, m_str):
        for key in a:
            assert torch.equal(a[key], b[key]), key
    for key, net in resident.networks.items():
        for (k, x), y in zip(net.state_dict().items(),
                             streamed.networks[key].state_dict().values()):
            assert torch.equal(x, y), (key, k)


@pytest.mark.parametrize("cls", [MTUBPLTrainer, DualPoseUBPLTrainer])
def test_streamed_ssl_steps_bit_equal(cls):
    """Two steps of the streamed trainer equal the resident trainer's on
    the same batches and draws, bit for bit (metrics, students, teachers,
    BN stats)."""
    resident, streamed = _pair(cls)
    assert streamed.train_data is None and resident.train_host is None
    batches = [list(b) for b in resident.make_sampler()][:2]
    assert batches == [list(b) for b in streamed.make_sampler()][:2]
    _same_steps(resident, streamed, batches, SCHED)


def test_streamed_supervised_steps_bit_equal():
    """The same for the supervised regime (one view per step)."""
    resident, streamed = _pair(SupervisedTrainer, label_ratio=1.0)
    batches = supervised_epoch_batches(resident.labeled_idxs, 2,
                                       np.random.default_rng(0))[:2]
    _same_steps(resident, streamed, batches, ())


def test_streamed_epoch_and_validation():
    """A streamed MT_UBPL run: the epoch's losses are finite, the
    validation set is resident on the device, the debug drawing reads the
    host arrays."""
    tr = MTUBPLTrainer(Config(**dict(KW, train_count=4, epochs=1, debug=True,
                                     stream_data=True)), device="cpu")
    assert tr.valid_data.images.device.type == "cpu"
    with tempfile.TemporaryDirectory() as base:
        (h,) = tr.run(base)
        assert os.listdir(os.path.join(base, "draw"))
    assert np.isfinite(h["pec_losses"]).all()


@pytest.mark.parametrize("field,value,match", [
    ("scan_batches", 2, "scan_batches"),
    ("pseudo_rounds", 1, "pseudo_rounds")])
def test_stream_data_guards_match_jax(field, value, match):
    """stream_data with scan_batches > 1 or with pseudo_rounds > 0 is the
    same ValueError as in the JAX package (the same subject in its
    message)."""
    from ubpl_tpu.config import Config as JConfig
    from ubpl_tpu.train.mt_ubpl import MTUBPLTrainer as JMTUBPLTrainer
    kw = dict(KW, stream_data=True, **{field: value})
    with pytest.raises(ValueError, match=match) as ours:
        MTUBPLTrainer(Config(**kw), device="cpu")
    with pytest.raises(ValueError, match=match) as theirs:
        JMTUBPLTrainer(JConfig(**kw))
    assert "stream_data" in str(ours.value) and "stream_data" in str(
        theirs.value)
    if field == "pseudo_rounds":
        assert str(ours.value) == str(theirs.value)


@pytest.mark.cuda
def test_streaming_on_cuda_uses_side_stream_and_pinned_memory():
    """On the card: pinned host arrays and staging buffers, the copy on a
    stream other than the default one, and the consumer waits on the copy's
    event (needs a CUDA device)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    h = ST.host_dataset(rng.integers(0, 256, (6, 8, 8, 3), dtype=np.uint8),
                        rng.uniform(0, 8, (6, K, 3)), np.zeros(6), dev)
    assert all(a.is_pinned() for a in h)
    s = ST.BatchStreamer(h, dev)
    assert s.stream != torch.cuda.default_stream(dev)
    for idxs, b in zip([[0, 1], [2, 3], [4, 5]], s.batches([[0, 1], [2, 3],
                                                            [4, 5]])):
        imgs, _, _ = b.take()
        assert torch.equal(imgs.cpu(), h.images[torch.as_tensor(idxs)])
    assert all(all(buf.is_pinned() for buf in slot.bufs)
               for slot in s._slots)
