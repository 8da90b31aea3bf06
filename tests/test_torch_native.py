"""The port's native host runtime (``spark_rapids_tpu_torch/native``): the JAX
package's C++ allocator and spill-order queue, copied byte for byte, built
by ``g++`` at first use and bound with ctypes; held against the port's
plain versions (``native/plain.py``) and the JAX package's Python twins and
C++ library under hypothesis sequences. The memory store runs on it."""
import filecmp
import os

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from spark_rapids_tpu import native as jnative
from spark_rapids_tpu_torch import native
from spark_rapids_tpu_torch.memory.buffer import StorageTier
from spark_rapids_tpu_torch.memory.store import (BufferCatalog,
                                                 DeviceMemoryStore,
                                                 HostMemoryStore)
from spark_rapids_tpu_torch.native import plain

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SETTINGS = settings(max_examples=60, deadline=None, derandomize=True)


@pytest.mark.parametrize("name", ["allocator.cpp", "priority_queue.cpp"])
def test_sources_are_byte_equal_copies(name):
    assert filecmp.cmp(
        os.path.join(ROOT, "spark_rapids_tpu", "native", "src", name),
        os.path.join(ROOT, "spark_rapids_tpu_torch", "native", "src", name),
        shallow=False)


def test_library_built_into_the_build_dir_by_content_hash():
    so = native.library_path()
    assert so.parent == native.BUILD_DIR
    assert so.name.startswith("libsrt_native-") and so.suffix == ".so"
    native.get_lib()
    assert so.exists()
    assert native.build() == (so, "")         # current: nothing compiled


def test_failed_build_raises_with_the_compiler_log(monkeypatch, tmp_path):
    bad = tmp_path / "src"
    bad.mkdir()
    (bad / "broken.cpp").write_text("int f( { return 0; }\n")
    monkeypatch.setattr(native, "SRC_DIR", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed") as err:
        native.build()
    assert "broken.cpp" in str(err.value)


def test_store_runs_on_the_native_runtime():
    cat = BufferCatalog()
    host = HostMemoryStore(cat, 1 << 20)
    dev = DeviceMemoryStore(cat, 1 << 20)
    try:
        assert isinstance(host.arena, native.AddressSpaceAllocator)
        assert isinstance(dev._spill_queue, native.HashedPriorityQueue)
        assert host.tier == StorageTier.HOST
    finally:
        dev.close()
        host.close()


def test_calls_after_close_raise_instead_of_crashing():
    arena = native.AddressSpaceAllocator(1 << 10)
    off = arena.allocate(64)
    arena.close()
    arena.close()                               # a second close is a no-op
    for call in (lambda: arena.allocate(8), lambda: arena.free(off),
                 lambda: arena.available, lambda: arena.largest_free_block):
        with pytest.raises(ValueError, match="AddressSpaceAllocator is closed"):
            call()
    pq = native.HashedPriorityQueue()
    pq.offer(1, 0.5)
    pq.close()
    for call in (lambda: pq.offer(2, 0.1), pq.poll, pq.peek,
                 lambda: pq.remove(1), lambda: 1 in pq, lambda: len(pq)):
        with pytest.raises(ValueError, match="HashedPriorityQueue is closed"):
            call()


def test_store_remove_after_close_leaves_the_arena_alone():
    import pyarrow as pa
    import torch

    from spark_rapids_tpu_torch.columnar.host import HostBatch
    from spark_rapids_tpu_torch.columnar.transfer import upload
    from spark_rapids_tpu_torch.memory.buffer import BufferId, SpillableBuffer
    cat = BufferCatalog()
    host = HostMemoryStore(cat, 1 << 20)
    db = upload(HostBatch.from_arrow(pa.table({"x": list(range(8))})),
                torch.device("cpu"))
    buf = SpillableBuffer.from_batch(BufferId(3), db).to_host()
    host.add_buffer(buf)
    assert host._offsets
    host.close()
    assert not host._offsets
    host.remove(buf.id)                         # late: a no-op, no crash


# ------------------------------------------------------------- allocator
ALLOC_OPS = st.lists(st.one_of(
    st.tuples(st.just("alloc"), st.integers(0, 300)),
    st.tuples(st.just("free"), st.integers(0, 40))), max_size=80)


def _alloc_trace(a, ops):
    live, out = [], []
    for op, v in ops:
        if op == "alloc":
            off = a.allocate(v)
            out.append(("alloc", off))
            if off is not None:
                live.append(off)
        elif live:
            off = live.pop(v % len(live))
            out.append(("free", a.free(off)))
        out.append((a.available, a.num_free_blocks, a.largest_free_block))
    out.append(("free-unknown", a.free(10 ** 6)))
    return out


@SETTINGS
@given(ALLOC_OPS)
def test_allocator_equals_plain_and_reference(ops):
    got = _alloc_trace(native.AddressSpaceAllocator(1000), ops)
    assert got == _alloc_trace(plain.PyAddressSpaceAllocator(1000), ops)
    assert got == _alloc_trace(jnative.PyAddressSpaceAllocator(1000), ops)


# ---------------------------------------------------------- spill queue
#: offers of keys not queued, removals, polls, peeks and contains: the
#: store's own use (a buffer is offered once per admission), on which all
#: three agree, ties included
PQ_OPS = st.lists(st.one_of(
    st.tuples(st.just("offer"), st.integers(0, 30), st.integers(0, 4)),
    st.tuples(st.just("remove"), st.integers(0, 30), st.just(0)),
    st.tuples(st.just("poll"), st.just(0), st.just(0)),
    st.tuples(st.just("peek"), st.just(0), st.just(0)),
    st.tuples(st.just("contains"), st.integers(0, 30), st.just(0))),
    max_size=80)


def _pq_trace(q, ops, reoffer: bool = False):
    out = []
    for op, k, p in ops:
        if op == "offer":
            if k in q and not reoffer:
                out.append(("skip",))
                continue
            out.append(("offer", q.offer(k, float(p))))
        elif op == "remove":
            out.append(("remove", q.remove(k)))
        elif op == "poll":
            out.append(("poll", q.poll()))
        elif op == "peek":
            out.append(("peek", q.peek()))
        else:
            out.append(("contains", k in q))
        out.append(len(q))
    while len(q):
        out.append(("drain", q.poll()))
    return out


@SETTINGS
@given(PQ_OPS)
def test_spill_queue_equals_plain_and_reference(ops):
    got = _pq_trace(native.HashedPriorityQueue(), ops)
    assert got == _pq_trace(plain.PyHashedPriorityQueue(), ops)
    assert got == _pq_trace(jnative.PyHashedPriorityQueue(), ops)


def test_equal_priorities_poll_first_in_first_out():
    for q in (native.HashedPriorityQueue(), plain.PyHashedPriorityQueue(),
              jnative.PyHashedPriorityQueue()):
        for k in (5, 3, 9, 1):
            q.offer(k, 2.0)
        q.offer(7, 1.0)
        assert [q.poll()[0] for _ in range(5)] == [7, 5, 3, 9, 1]


@SETTINGS
@given(PQ_OPS)
def test_reoffer_order_equals_the_reference_library(ops):
    """Updating a queued key's priority: the port's library and the JAX
    package's (the order its store runs with a toolchain) agree on every
    sequence, ties included."""
    got = _pq_trace(native.HashedPriorityQueue(), ops, reoffer=True)
    assert got == _pq_trace(jnative._NativeHashedPriorityQueue(), ops,
                            reoffer=True)


def test_reoffer_tie_rule_of_the_library_and_the_twins():
    """The one order the C++ and the Python twins break differently, in
    both packages: a queued key offered again at an equal priority keeps
    its first place in the C++ and goes behind its equals in the twins.
    The store never offers a queued key, so its spill order is the same
    either way."""
    def order(q):
        q.offer(1, 5.0)
        q.offer(2, 5.0)
        q.offer(1, 5.0)
        return [q.poll()[0], q.poll()[0]]
    assert order(native.HashedPriorityQueue()) == [1, 2]
    assert order(jnative._NativeHashedPriorityQueue()) == [1, 2]
    assert order(plain.PyHashedPriorityQueue()) == [2, 1]
    assert order(jnative.PyHashedPriorityQueue()) == [2, 1]
