"""The port's host data plane (``data/assembler.py``, ``data/loader.py``) on
the CPU: the assembly and completion pools' contracts (the cases of the JAX
package's ``tests/test_assembler.py``), byte-identical batch streams across
the serial, prefetched and pooled loaders, and fault substitution against
the JAX loader under the same ``MX_RCNN_FAULTS`` specs: the same slots
filled, the same counters, the budget exceeded at the same record, from
pool workers too.  Numpy only: no model is built."""

import dataclasses
import math
import threading
import time

import numpy as np
import pytest

from mx_rcnn_tpu.data import loader as jloader
from mx_rcnn_tpu.utils import faults as jfaults
from mx_rcnn_tpu_torch.data import loader as tloader
from mx_rcnn_tpu_torch.data.assembler import (
    AssemblyPool,
    CompletionPool,
    default_assembly_workers,
)
from mx_rcnn_tpu_torch.data.synthetic import SyntheticDataset
from mx_rcnn_tpu_torch.utils import faults as tfaults
from tests.test_model import tiny_cfg
from tests.test_torch_model import port_cfg


# ------------------------------------------------------------ AssemblyPool
# The pool's workers are spawned processes: its work functions must be
# picklable, so these cases use the standard library's.
class TestAssemblyPool:
    def test_imap_yields_in_submission_order(self):
        """Later items finishing first (each item a shorter sum than the
        one before) must not reorder the stream."""
        items = [range((12 - i) * 200_000) for i in range(12)]
        pool = AssemblyPool(4, name="t")
        assert list(pool.imap(sum, items)) == [sum(r) for r in items]
        s = pool.stats()
        assert s["submitted"] == s["completed"] == s["yielded"] == 12
        assert 0.0 <= s["occupancy"] <= 1.0 and s["queue_depth_max"] >= 1
        assert s["ready_hits"] + s["starved"] == 12
        pool.close()

    def test_exception_surfaces_at_its_position(self):
        pool = AssemblyPool(2, name="t")
        it = pool.imap(math.sqrt, [4.0, 9.0, 16.0, -1.0, 25.0, 36.0])
        assert [next(it) for _ in range(3)] == [2.0, 3.0, 4.0]
        with pytest.raises(ValueError, match="math domain error"):
            next(it)
        pool.close()
        pool.close()  # idempotent

    def test_workers_zero_is_serial_inline(self):
        pool = AssemblyPool(0, name="t")
        assert list(pool.imap(lambda i: i + 1, range(5))) == [1, 2, 3, 4, 5]
        s = pool.stats()
        assert s["workers"] == 0 and s["yielded"] == 5 and s["ready_hits"] == 0
        pool.close()

    def test_close_abandons_unconsumed_work(self):
        pool = AssemblyPool(2, name="t")
        it = pool.imap(time.sleep, [0.02] * 50, window=4)
        assert next(it) is None
        it.close()
        pool.close()
        assert pool.stats()["completed"] < 50

    def test_default_workers_env(self, monkeypatch):
        monkeypatch.delenv("MX_RCNN_ASSEMBLY_WORKERS", raising=False)
        assert default_assembly_workers() == 0
        monkeypatch.setenv("MX_RCNN_ASSEMBLY_WORKERS", "3")
        assert default_assembly_workers() == 3
        pool = AssemblyPool()
        assert pool.workers == 3
        pool.close()


# ---------------------------------------------------------- CompletionPool
class TestCompletionPool:
    @pytest.mark.parametrize("workers", [0, 4])
    def test_index_addressed_accumulation_is_deterministic(self, workers):
        n = 24
        slots = [None] * n
        pool = CompletionPool(workers, name="t")

        def work(i):
            time.sleep(((i * 7) % 5) * 0.001)
            slots[i] = i * 3

        for i in range(n):
            pool.submit(work, i)
        pool.drain()
        pool.close()
        assert slots == [i * 3 for i in range(n)]

    def test_drain_reraises_first_worker_error(self):
        pool = CompletionPool(2, name="t")

        def work(i):
            if i == 5:
                raise RuntimeError("postprocess died")

        for i in range(10):
            pool.submit(work, i)
        with pytest.raises(RuntimeError, match="postprocess died"):
            pool.drain()
        assert pool.stats()["errors"] == 1
        pool.close()

    def test_inline_error_raises_at_submit(self):
        pool = CompletionPool(0, name="t")
        with pytest.raises(RuntimeError, match="inline"):
            pool.submit(lambda: (_ for _ in ()).throw(RuntimeError("inline")))
        pool.close()

    def test_inflight_bounded_by_depth(self):
        depth = 2
        pool = CompletionPool(2, depth=depth, name="t")
        live, peak = [0], [0]
        lock = threading.Lock()

        def work():
            with lock:
                live[0] += 1
                peak[0] = max(peak[0], live[0])
            time.sleep(0.01)
            with lock:
                live[0] -= 1

        for _ in range(10):
            pool.submit(work)
        pool.drain()
        pool.close()
        assert peak[0] <= depth
        assert pool.stats()["inflight_max"] <= depth


# -------------------------------------------------------------- TrainLoader
def loader_cfgs():
    """``tests/test_torch_train.py``'s 96 × 128 config, JAX and port."""
    jcfg = tiny_cfg().replace(SHAPE_BUCKETS=((96, 128), (128, 96)))
    jcfg = jcfg.replace(dataset=dataclasses.replace(jcfg.dataset, SCALES=((96, 128),)))
    return jcfg, port_cfg(jcfg)


@pytest.fixture(scope="module")
def roidb():
    return SyntheticDataset(num_images=8, image_size=(160, 200)).gt_roidb()


@pytest.fixture(autouse=True)
def clean_caches():
    """The JAX render LRU keys renders without their size: drop this file's
    160 × 200 renders, and start every test with empty registries."""
    jfaults.reset()
    tfaults.reset()
    yield
    jloader._RENDER_CACHE.clear()
    tfaults.reset()
    jfaults.reset()


def _stream(roidb, cfg, **kw):
    loader = tloader.TrainLoader(roidb, cfg, 2, shuffle=True, seed=3, **kw)
    it = iter(loader)
    try:
        return list(it), loader
    finally:
        it.close()
        loader.close()


@pytest.mark.parametrize("workers,prefetch", [(0, 2), (2, 0), (2, 2)])
def test_train_loader_streams_are_byte_identical(roidb, workers, prefetch):
    _, cfg = loader_cfgs()
    ref, _ = _stream(roidb, cfg, assembly_workers=0, prefetch=0)
    got, _ = _stream(roidb, cfg, assembly_workers=workers, prefetch=prefetch)
    assert len(got) == len(ref) == 4
    for a, b in zip(got, ref):
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes(), k


def _fault_run(mod, roidb, cfg, workers, budget=None):
    loader = mod.TrainLoader(roidb, cfg, 2, shuffle=True, seed=3, assembly_workers=workers,
                             failure_budget=budget)
    seeds, raised = [], None
    it = iter(loader)
    try:
        for b in it:
            seeds.append(b["sample_seeds"].tolist())
    except (jloader.LoaderFaultBudgetExceeded, tloader.LoaderFaultBudgetExceeded) as e:
        raised = str(e).split(":")[0] + " " + str(e).split("latest: ")[1].split(" ")[1]
    finally:
        it.close()
        if hasattr(loader, "close"):
            loader.close()
    return {"seeds": seeds, "raised": raised, "record_failures": loader.record_failures,
            "substituted_records": loader.substituted_records,
            "dropped_batches": loader.dropped_batches}


@pytest.mark.parametrize("workers", [0, 2])
def test_record_faults_substitute_the_same_slots_as_jax(monkeypatch, roidb, workers):
    """A corrupt record's slot takes its batch's first good record, a read
    that fails twice succeeds on the third try, a batch with no loadable
    record is dropped: the same seeds and counters as the JAX loader."""
    jcfg, cfg = loader_cfgs()
    plan = tloader.TrainLoader(roidb, cfg, 2, shuffle=True, seed=3)._epoch_plan(0)
    (_, a), (_, b), (_, c) = plan[0], plan[1], plan[2]
    monkeypatch.setenv("MX_RCNN_FAULTS", f"record_fail@{a[0]},record_fail@{b[1]}x2,"
                                         f"record_fail@{c[0]},record_fail@{c[1]}")
    ref = _fault_run(jloader, roidb, jcfg, workers)
    got = _fault_run(tloader, roidb, cfg, workers)
    assert got == ref
    assert got["seeds"][0] == [a[1], a[1]] and got["seeds"][1] == b and len(got["seeds"]) == 3
    assert (got["record_failures"], got["substituted_records"], got["dropped_batches"]) == (3, 1, 1)


@pytest.mark.parametrize("workers", [0, 2])
def test_fault_budget_exceeded_at_the_same_record_as_jax(monkeypatch, roidb, workers):
    jcfg, cfg = loader_cfgs()
    plan = tloader.TrainLoader(roidb, cfg, 2, shuffle=True, seed=3)._epoch_plan(0)
    a, b = plan[1][1]
    monkeypatch.setenv("MX_RCNN_FAULTS", f"record_fail@{a},record_fail@{b}")
    ref = _fault_run(jloader, roidb, jcfg, workers, budget=1)
    got = _fault_run(tloader, roidb, cfg, workers, budget=1)
    assert got == ref
    assert got["raised"] == f"2 records failed to load (budget 1); latest {b}"
    assert got["seeds"] == [plan[0][1]]


def test_render_cache_serves_the_loader(roidb):
    rec = roidb[0]
    tloader._RENDER_CACHE.clear()
    im = tloader.load_record_image(rec)
    assert tloader.load_record_image(rec) is im
    assert (tloader._RENDER_CACHE.hits, tloader._RENDER_CACHE.misses) == (1, 1)
    other = dict(rec, height=150, width=190)  # same uri and seed, another size
    assert tloader.load_record_image(other).shape == (150, 190, 3)
    lru = tloader._RenderLRU(max_entries=2)
    for k in range(3):
        lru.put(k, np.full((1,), k))
    assert len(lru) == 2 and lru.evictions == 1 and lru.get(0) is None


def test_prepared_cache_is_bit_identical(roidb):
    _, cfg = loader_cfgs()
    rec = roidb[0]
    bucket = tloader._orientation_bucket(rec, cfg.SHAPE_BUCKETS)
    ref = tloader.make_batch([rec], cfg, bucket)
    tloader.set_prepared_cache(4)
    try:
        first = tloader.make_batch([rec], cfg, bucket)
        second = tloader.make_batch([rec], cfg, bucket)
        assert tloader._PREPARED_CACHE.hits == 1
    finally:
        tloader.set_prepared_cache(0)
    for k in ref:
        assert ref[k].tobytes() == first[k].tobytes() == second[k].tobytes()


@pytest.mark.parametrize("workers", [0, 2])
def test_skip_batches_drops_the_front_of_the_next_epoch(roidb, workers):
    """``skip_batches`` resumes an epoch's deterministic plan part way: the
    next stream is the full one without its first entries, and the epoch
    after is whole again."""
    _, cfg = loader_cfgs()
    full, _ = _stream(roidb, cfg, assembly_workers=workers)
    loader = tloader.TrainLoader(roidb, cfg, 2, shuffle=True, seed=3, assembly_workers=workers)
    loader.skip_batches = 3
    try:
        skipped = list(iter(loader))
        assert loader.skip_batches == 0 and len(list(iter(loader))) == len(loader)
    finally:
        loader.close()
    assert [b["sample_seeds"].tolist() for b in skipped] == [
        b["sample_seeds"].tolist() for b in full[3:]]


def test_prefetch_iterator_reraises_and_closes():
    """The prefetch thread hands a worker error to the consumer after the
    items before it, and ``close`` reclaims a worker parked on a full
    queue."""
    def source():
        yield 1
        yield 2
        raise OSError("decode failed")

    it = tloader.PrefetchIterator(source(), prefetch=2)
    assert [next(it), next(it)] == [1, 2]
    with pytest.raises(OSError, match="decode failed"):
        next(it)
    it.close()

    endless = tloader.PrefetchIterator(iter(lambda: 0, 1), prefetch=2)
    assert next(endless) == 0
    endless.close()
    assert not endless._thread.is_alive()
    with pytest.raises(StopIteration):
        next(endless)
