"""Shared set-up of the benchmark's own tests: the checkout's root on the
path, one torch thread, and tiny copies of the cells for the CPU."""
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


#: cells whose files the benchmark holds but that ``BENCHMARK.json`` does
#: not list (PERF.md, Open questions), each with its entry and the
#: end-to-end metrics it would report: the tests rehearse them as if listed
STAGED = {"train-mt_ubpl-hg3-model2-data2": (
    {"config": "hg3-k9-256", "traffic": "mt_ubpl-16u16l-model2-data2",
     "chips": 4}, ["train_images_per_s"])}


def spec():
    """``BENCHMARK.json`` with the staged cells it lacks added."""
    from benchmark import harness
    out = harness.load_spec()
    listed = {w["name"] for w in out["workloads"]}
    for name, (entry, metrics) in STAGED.items():
        if name in listed:
            continue
        out["workloads"].append({"name": name, **entry})
        for m in out["end_to_end"]:
            if m["name"] in metrics:
                m["workloads"].append(name)
    return out


def cells():
    """The names of the listed and the staged cells."""
    return [w["name"] for w in spec()["workloads"]]


def tiny_cell(name):
    """The cell ``name`` (listed or staged) with its files read, cut to a
    size the CPU runs in seconds: the keys of its configuration's and its
    traffic's ``"tiny"`` entries replace theirs."""
    from benchmark import harness
    return tiny(harness.Cell(name, spec()))


def tiny(cell):
    """``cell`` cut by its files' ``"tiny"`` entries; raises, naming the
    file, where one has none, so that no cell runs on the CPU at its full
    size."""
    for what, body in (("configuration", cell.config),
                       ("traffic", cell.traffic)):
        if "tiny" not in body:
            raise ValueError(
                f"{cell.name}: its {what} has no \"tiny\" entry, the keys "
                "that cut it to a CPU size; add one to the file")
        body.update(body["tiny"])
    return cell


@pytest.fixture(autouse=True)
def _one_thread():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
