"""``train/prefetch.py``'s contract (the JAX package's ``device_prefetch``):
batches in order, a worker's exception re-raised at the consumer, the
worker stopped when the consumer abandons the iterator, ``depth <= 0``
synchronous; and ``--device_prefetch`` training the same weights as the
synchronous run."""

import threading
import time

import numpy as np
import pytest
import torch

from neurips18_hierchical_image_manipulation_tpu_torch.cli import box2mask_train
from neurips18_hierchical_image_manipulation_tpu_torch.train.prefetch import (
    device_prefetch,
    ready,
    to_device,
)
from torch_port_helpers import restore_torch_precision  # noqa: F401  (fixture)
from test_torch_box2mask_cli import TRAIN, dataroot  # noqa: F401  (fixture)


def prefetch_threads():
    return [t for t in threading.enumerate()
            if t.name == "himan-h2d-prefetch" and t.is_alive()]


@pytest.mark.parametrize("depth", [0, 1, 3])
def test_order_and_pairs(depth):
    out = list(device_prefetch(iter(range(20)), lambda b: b * 10, depth))
    assert out == [(b * 10, b) for b in range(20)]


def test_depth_zero_runs_inline():
    seen = []
    it = device_prefetch(iter(range(3)), lambda b: seen.append(threading.current_thread()) or b,
                         0)
    list(it)
    assert seen == [threading.current_thread()] * 3


@pytest.mark.parametrize("where", ["loader", "put_fn"])
def test_worker_exception_reraises_at_consumer(where):
    def loader():
        yield 0
        yield 1
        if where == "loader":
            raise RuntimeError("loader broke")
        yield 2

    def put(b):
        if where == "put_fn" and b == 2:
            raise RuntimeError("put_fn broke")
        return b

    it = device_prefetch(loader(), put, 2)
    assert [next(it)[1], next(it)[1]] == [0, 1]
    with pytest.raises(RuntimeError, match=f"{where} broke"):
        next(it)
    time.sleep(0.2)
    assert not prefetch_threads()


def test_worker_stops_when_abandoned():
    staged = []

    def put(b):
        staged.append(b)
        return b

    it = device_prefetch(iter(range(1000)), put, 2)
    assert next(it)[0] == 0
    it.close()
    n = len(staged)
    time.sleep(0.5)
    assert len(staged) == n and n <= 4
    assert not prefetch_threads()


def test_to_device_and_ready_on_cpu():
    hb = {"a": np.arange(4, dtype=np.int32), "t": torch.ones(2), "path": ["x"]}
    b = ready(to_device(hb, torch.device("cpu")))
    assert set(b) == {"a", "t"} and b["a"].dtype == torch.int32


def test_cli_prefetch_equals_synchronous(dataroot, tmp_path, restore_torch_precision):  # noqa: F811
    """box2mask_train with --device_prefetch 2 trains the weights of the
    synchronous run, bit for bit."""
    states = {}
    for depth in ("0", "2"):
        ckpt = str(tmp_path / f"ckpt{depth}")
        box2mask_train.main(["--name", "p", "--dataroot", dataroot, "--checkpoints_dir", ckpt,
                             "--niter", "1", "--print_freq", "100", "--device_prefetch", depth,
                             *TRAIN])
        states[depth] = torch.load(f"{ckpt}/p/ckpt/latest/state.pt", weights_only=False)
    for net in ("G", "D"):
        for k, t in states["0"]["params"][net].items():
            assert torch.equal(states["2"]["params"][net][k], t), (net, k)
    assert states["0"]["step"] == states["2"]["step"] == 4
