"""Cluster executor daemon: one OS process per executor.

Started by ``parallel/cluster.py::ProcessExecutor`` with a control port:
``python -m spark_rapids_tpu_torch.parallel.executor_daemon --executor-id
exec-0 --control-port PORT``. Its ``init`` message carries the conf and the
session's device; the daemon opens that device (``cuda`` with no GPU
fails the start: it never carries on on the CPU), builds a ShuffleEnv on
the configured transport (TCP between processes) and serves tasks until
told to stop. The control socket carries task specs and results only:
shuffle data moves executor to executor over the transport's own sockets.

On the CPU the daemon runs torch on one thread, as the tests do.
"""
from __future__ import annotations

import argparse
import socket
import sys
import tempfile
import threading
import traceback

from spark_rapids_tpu_torch.utils import errors as uerr


@uerr.triage_boundary
def _reply_error(send, rid, exc: BaseException) -> None:
    """A failed request's reply: its error through the wire codec
    (utils/errors.py), which the driver's side of the request decodes and
    re-raises, so a ladder signal (a shipped blob's ``ChecksumError``)
    reaches the rung that triages it instead of ending here."""
    send({"type": "error", "id": rid,
          "error": uerr.encode_error(exc, message=traceback.format_exc()),
          "message": traceback.format_exc()})


def _cache_put(conf, device, cached_parts, tid: int, parts) -> None:
    """Register a shipped df.cache() entry's partitions in this executor's
    spillable catalog under the driver's BufferIds, so they spill device ->
    host -> disk under pressure like any cached buffer."""
    from spark_rapids_tpu_torch.memory.buffer import BufferId
    from spark_rapids_tpu_torch.memory.device_manager import DeviceManager
    from spark_rapids_tpu_torch.memory.store import CACHE_BUFFER_PRIORITY
    from spark_rapids_tpu_torch.parallel.broadcast import \
        deserialize_to_device

    _cache_remove(cached_parts, tid)      # a stale generation, if any
    dm = DeviceManager.initialize(conf, device)
    ids = []
    try:
        for i, blob in enumerate(parts):
            bid = BufferId(tid, i)
            dm.device_store.add_batch(bid, deserialize_to_device(blob, device),
                                      CACHE_BUFFER_PRIORITY)
            ids.append(bid)
    except Exception:
        # a failure mid-loop must not orphan the partitions registered
        # already
        for bid in ids:
            dm.catalog.remove(bid)
        raise
    cached_parts[tid] = ids


def _cache_remove(cached_parts, tid: int) -> None:
    from spark_rapids_tpu_torch.memory.device_manager import DeviceManager
    ids = cached_parts.pop(tid, None)
    if ids:
        dm = DeviceManager.peek()
        if dm is not None:
            for bid in ids:
                dm.catalog.remove(bid)


def _pong(env, reset_peak: bool = False) -> dict:
    """The liveness answer: whether the shuffle transport was killed (the
    control socket can outlive it), the device and its peak memory (since
    the start or the last ping with ``reset_peak``, which resets it after
    reading), the shuffle bytes this process fetched from its peers
    (``host_hop_bytes``), this process's kernel counts (the reorder's
    launches and kept outputs, the compact's launches) and the top-level
    packages loaded."""
    import torch
    from spark_rapids_tpu_torch.parallel import mesh_batch
    from spark_rapids_tpu_torch.shuffle import partition_kernel as pk
    t = env.transport
    killed = bool(getattr(t, "killed", False) or getattr(t, "_killed", False))
    peak = 0
    if env.device.type == "cuda":
        peak = torch.cuda.max_memory_allocated(env.device)
        if reset_peak:
            torch.cuda.reset_peak_memory_stats(env.device)
    return {"type": "pong", "killed": killed, "device": str(env.device),
            "peak_bytes": int(peak),
            "host_hop_bytes": mesh_batch.counters()["host_hop_bytes"],
            "reorder_launches": pk.REORDER_KERNEL.launches,
            "reorder_kept": pk.REORDER_KERNEL.kept,
            "compact_launches": pk.COMPACT_KERNEL.launches,
            "packages": sorted({m.split(".")[0] for m in sys.modules})}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--executor-id", required=True)
    ap.add_argument("--control-port", type=int, required=True)
    args = ap.parse_args()

    sock = socket.create_connection(("127.0.0.1", args.control_port),
                                    timeout=60)
    sock.settimeout(None)  # connect bound only; serving blocks indefinitely
    from spark_rapids_tpu_torch.parallel.cluster import (_recv_msg, _run_task,
                                                         _send_msg)
    from spark_rapids_tpu_torch.shuffle.manager import ShuffleEnv

    env = None
    cached_parts: dict = {}      # df.cache() table_id -> [BufferId...]
    spill_dir = tempfile.mkdtemp(prefix=f"spill-{args.executor_id}-")
    try:
        msg = _recv_msg(sock)
        if msg.get("type") != "init":
            raise RuntimeError(f"expected an init message, got {msg!r}")
        conf = msg["conf"]
        import torch
        from spark_rapids_tpu_torch import device as device_mod
        device = device_mod.resolve(msg["device"])
        if device.type == "cpu":
            torch.set_num_threads(1)
        else:
            torch.cuda.set_device(device)
        env = ShuffleEnv(args.executor_id, conf, disk_dir=spill_dir,
                         device=device)
        _send_msg(sock, {"type": "ready", "device": str(device)})

        # responses of concurrent task threads interleave: serialize the
        # socket writes; the driver routes them back by id
        send_lock = threading.Lock()

        def send(obj) -> None:
            with send_lock:
                _send_msg(sock, obj)

        while True:
            msg = _recv_msg(sock)
            kind = msg["type"]
            rid = msg.get("id")
            if kind == "stop":
                return 0
            if kind == "ping":
                send({**_pong(env, bool(msg.get("reset_peak"))),
                      "id": rid})
                continue
            if kind == "cleanup":
                env.shuffle_catalog.remove_shuffle(msg["shuffle_id"])
                send({"type": "ok", "id": rid})
                continue
            if kind == "cleanup_map":
                env.shuffle_catalog.remove_map_outputs(msg["shuffle_id"],
                                                       msg["map_id"])
                send({"type": "ok", "id": rid})
                continue
            if kind == "broadcast":
                from spark_rapids_tpu_torch.parallel.broadcast import \
                    BroadcastManager
                BroadcastManager.put(msg["bid"], msg["blob"])
                send({"type": "ok", "id": rid})
                continue
            if kind == "cleanup_broadcast":
                from spark_rapids_tpu_torch.parallel.broadcast import \
                    BroadcastManager
                BroadcastManager.remove(msg["bid"])
                send({"type": "ok", "id": rid})
                continue
            if kind == "cache_put":
                try:
                    _cache_put(conf, device, cached_parts, msg["tid"],
                               msg["parts"])
                    send({"type": "ok", "id": rid})
                except Exception as e:
                    _reply_error(send, rid, e)
                continue
            if kind == "cache_remove":
                _cache_remove(cached_parts, msg["tid"])
                send({"type": "ok", "id": rid})
                continue
            if kind == "task":
                # one thread per task in flight (the driver bounds them to
                # taskSlots per executor)
                @uerr.wire_boundary
                def run(spec=msg["spec"], rid=rid) -> None:
                    from spark_rapids_tpu_torch.shuffle.manager import \
                        ShuffleFetchFailedError
                    try:
                        blob = _run_task(env, spec)
                        send({"type": "done", "blob": blob, "id": rid})
                    except ShuffleFetchFailedError as e:
                        # the structured codec (utils/errors.py) keeps the
                        # scoped payload across the control socket: the
                        # driver's recompute loop keys off executor_id and
                        # blocks
                        send({"type": "error", "id": rid,
                              "error": uerr.encode_error(e),
                              "message": str(e)})
                    except Exception as e:
                        # unregistered types ship OPAQUE (not retryable on
                        # the driver) with the traceback as message
                        send({"type": "error", "id": rid,
                              "error": uerr.encode_error(
                                  e, message=traceback.format_exc()),
                              "message": traceback.format_exc()})

                threading.Thread(target=run, daemon=True).start()
                continue
            send({"type": "error", "id": rid,
                  "message": f"unknown control message {kind!r}"})
    except (ConnectionError, EOFError):
        return 0
    finally:
        if env is not None:
            env.close()
        import shutil
        shutil.rmtree(spill_dir, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
